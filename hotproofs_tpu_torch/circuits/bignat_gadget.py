"""Non-native ("BigNat") field arithmetic in-circuit.

The augmented IVC circuit folds the OTHER side's running instance: its
group elements are native (ec_gadget.py), but the instance's scalars —
the relaxation factor u and the public IO X — live in the other circuit's
field. Folding them (X' = X + r·x2 mod m, u' = u + r mod m) needs foreign-
modulus arithmetic inside this circuit (arecibo does the same through
bellpepper nonnative gadgets; SURVEY.md §2b).

Representation: a foreign element is 4 little-endian 64-bit limbs, each a
circuit value range-checked to 64 bits; canonical means < m. Both Pasta
moduli (and BN254/Grumpkin) are 254-255 bits, so limb products (< 2^130)
and their 4-term sums (< 2^132) stay far below the native modulus.

mul_mod soundness: the prover hints quotient k and remainder rem of
a·b/m; the circuit enforces the INTEGER identity  a·b == k·m + rem  via
two congruences that CRT back to the integers:
  * mod native q: one linear constraint over the limb signals
    (coefficients 2^{64·i} mod q);
  * mod 2^320: a 5-position carry chain with signed-carry hints
    (biased into [0, 2^70) for range checks).
Bounds: a, b canonical < 2^255 so a·b < 2^510 and k < 2^256 (4 limbs);
|lhs − rhs| < 2^512 < q·2^320, so agreeing mod q AND mod 2^320 forces
exact integer equality, hence rem ≡ a·b (mod m). rem is further
constrained canonical (< m) so downstream absorbs/comparisons are on a
unique representative.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from . import gadgets as g
from .dsl import Value

LIMB_BITS = 64
N_LIMBS = 4
CARRY_POSITIONS = 5          # integer identity checked mod 2^320
CARRY_BIAS_BITS = 69         # |carry| < 2^68; biased into [0, 2^70)


def limbs_of_int(v: int) -> List[int]:
    return [(v >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1)
            for i in range(N_LIMBS)]


def int_of_limbs(limbs: Sequence[int]) -> int:
    return sum(int(l) << (LIMB_BITS * i) for i, l in enumerate(limbs))


@dataclass
class BigNat:
    """A foreign-field element as 4 range-checked 64-bit limb values."""

    limbs: List[Value]          # little-endian

    def value_expr(self, weights: Sequence[int]) -> Value:
        """Native-field linear combination sum(limb_i * w_i)."""
        acc: Value = 0
        for l, w in zip(self.limbs, weights):
            acc = acc + l * w
        return acc


def _range_check(ctx, v: Value, bits: int, name: str) -> None:
    g.tobits(ctx, v, bits, name=name)


def alloc(ctx, value_fn, deps: Sequence[Value], name: str = "bn") -> BigNat:
    """Allocate a foreign element from a host hint (4 limbs, range-checked).
    value_fn(dep_values...) -> int in [0, 2^256)."""
    limbs = ctx.hint_vec(lambda *a: limbs_of_int(int(value_fn(*a))),
                         deps, N_LIMBS, name=name)
    for i, l in enumerate(limbs):
        _range_check(ctx, l, LIMB_BITS, f"{name}_rc{i}")
    return BigNat(list(limbs))


def from_bits(ctx, bits_le: Sequence[Value], name: str = "bnb") -> BigNat:
    """Pack boolean values (caller enforces booleanity) into limbs; values
    shorter than 256 bits zero-fill the top. No extra constraints — the
    limbs are linear combinations of the bits."""
    limbs: List[Value] = []
    for i in range(N_LIMBS):
        chunk = bits_le[i * LIMB_BITS: (i + 1) * LIMB_BITS]
        acc: Value = 0
        for j, b in enumerate(chunk):
            acc = acc + b * (1 << j)
        limbs.append(acc)
    return BigNat(limbs)


def constant(v: int) -> BigNat:
    return BigNat([int(l) for l in limbs_of_int(v)])


def assert_equal(ctx, a: BigNat, b: BigNat) -> None:
    """Limbwise equality (both sides must be canonical / same form)."""
    for la, lb in zip(a.limbs, b.limbs):
        ctx.enforce(0, 0, la - lb)


def assert_less_than_m(ctx, a: BigNat, m: int, name: str = "ltm") -> None:
    """a < m for canonical-form outputs: compare limbs MSB-first.

    lt_i / eq_i per limb via 65-bit decomposition of (m_i - a_i - 1 + 2^64)
    and is_zero; combined lexicographically."""
    m_limbs = limbs_of_int(m)
    lt_flags, eq_flags = [], []
    for i in range(N_LIMBS):
        lt = g.less_than(ctx, a.limbs[i], m_limbs[i], LIMB_BITS + 1)
        eq = g.is_equal(ctx, a.limbs[i], m_limbs[i])
        lt_flags.append(lt)
        eq_flags.append(eq)
    # lex: lt_3 OR (eq_3 AND (lt_2 OR (eq_2 AND ...)))
    acc: Value = lt_flags[0]
    for i in range(1, N_LIMBS):
        and_term = g.mul(ctx, eq_flags[i], acc, name=f"{name}_and{i}")
        acc = lt_flags[i] + and_term - \
            g.mul(ctx, lt_flags[i], and_term, name=f"{name}_or{i}")
    ctx.enforce(0, 0, acc - 1)


def _enforce_integer_identity(ctx, q: int, lhs_limbs: List[Value],
                              rhs_limbs: List[Value], name: str) -> None:
    """Enforce sum(lhs_i 2^64i) == sum(rhs_i 2^64i) as INTEGERS, given all
    limb values are bounded < 2^132: (1) equality mod native q (one linear
    constraint), (2) equality mod 2^320 (5-position carry chain)."""
    n = max(len(lhs_limbs), len(rhs_limbs), CARRY_POSITIONS)
    lhs_limbs = list(lhs_limbs) + [0] * (n - len(lhs_limbs))
    rhs_limbs = list(rhs_limbs) + [0] * (n - len(rhs_limbs))

    # (1) mod q — linear, coefficients reduced mod q.
    acc: Value = 0
    for i, (lo, hi) in enumerate(zip(lhs_limbs, rhs_limbs)):
        w = pow(2, LIMB_BITS * i, q)
        acc = acc + (lo - hi) * w
    ctx.enforce(0, 0, acc)

    # (2) mod 2^320 — signed carries biased non-negative.
    bias = 1 << (CARRY_BIAS_BITS - 1)
    carry_prev: Value = 0
    prev_int = 0  # eval-mode mirror for the hint chain

    def carry_fn(*vals):
        # vals: (carry_prev, lhs_i, rhs_i) as ints
        c_prev, lo, hi = vals
        c_prev -= bias  # undo bias of the previous hint (0 for the first)
        d = c_prev + lo - hi
        assert d % (1 << LIMB_BITS) == 0, "integer identity broken"
        return (d >> LIMB_BITS) + bias

    for i in range(CARRY_POSITIONS):
        lo, hi = lhs_limbs[i], rhs_limbs[i]
        c = ctx.hint(carry_fn, [carry_prev if i else bias, lo, hi],
                     name=f"{name}_c{i}")
        _range_check(ctx, c, CARRY_BIAS_BITS + 1, f"{name}_crc{i}")
        # (c_prev - bias) + lhs - rhs == (c - bias) * 2^64
        prev_term = (carry_prev - bias) if i else 0
        ctx.enforce(0, 0, prev_term + lo - hi - (c - bias) * (1 << LIMB_BITS))
        carry_prev = c


def mul_mod(ctx, m: int, a: BigNat, b: BigNat, name: str = "bnm") -> BigNat:
    """rem = a·b mod m (canonical), via hinted quotient + integer identity."""
    q = ctx.p
    # Limb products (signals) and their positional sums t_i, i = 0..6.
    prods = {}
    for i in range(N_LIMBS):
        for j in range(N_LIMBS):
            prods[(i, j)] = g.mul(ctx, a.limbs[i], b.limbs[j],
                                  name=f"{name}_p{i}{j}")
    t: List[Value] = []
    for s in range(2 * N_LIMBS - 1):
        acc: Value = 0
        for i in range(N_LIMBS):
            j = s - i
            if 0 <= j < N_LIMBS:
                acc = acc + prods[(i, j)]
        t.append(acc)

    ab_int = lambda *ls: (int_of_limbs(ls[:N_LIMBS])
                          * int_of_limbs(ls[N_LIMBS:]))
    k = alloc(ctx, lambda *ls: ab_int(*ls) // m, a.limbs + b.limbs,
              name=f"{name}_k")
    rem = alloc(ctx, lambda *ls: ab_int(*ls) % m, a.limbs + b.limbs,
                name=f"{name}_r")
    assert_less_than_m(ctx, rem, m, name=f"{name}_ltm")

    m_limbs = limbs_of_int(m)
    km: List[Value] = []
    for s in range(2 * N_LIMBS - 1):
        acc: Value = 0
        for i in range(N_LIMBS):
            j = s - i
            if 0 <= j < N_LIMBS:
                acc = acc + k.limbs[i] * m_limbs[j]
        km.append(acc)
    rhs = [km[i] + (rem.limbs[i] if i < N_LIMBS else 0)
           for i in range(2 * N_LIMBS - 1)]
    _enforce_integer_identity(ctx, q, t, rhs, name=f"{name}_id")
    return rem


def add_mod(ctx, m: int, a: BigNat, b: BigNat, name: str = "bna") -> BigNat:
    """rem = a + b mod m (canonical): out = a + b - borrow·m, borrow
    boolean, out range-checked canonical; the identity is limbwise with a
    short carry chain (sums < 2^66 per position)."""
    q = ctx.p

    def out_fn(*ls):
        return (int_of_limbs(ls[:N_LIMBS]) + int_of_limbs(ls[N_LIMBS:])) % m

    def borrow_fn(*ls):
        return (int_of_limbs(ls[:N_LIMBS]) + int_of_limbs(ls[N_LIMBS:])) // m

    out = alloc(ctx, out_fn, a.limbs + b.limbs, name=f"{name}_o")
    assert_less_than_m(ctx, out, m, name=f"{name}_ltm")
    borrow = ctx.hint(borrow_fn, a.limbs + b.limbs, name=f"{name}_b")
    ctx.enforce(borrow, borrow, borrow)   # boolean (a+b < 2m)
    m_limbs = limbs_of_int(m)
    lhs = [a.limbs[i] + b.limbs[i] for i in range(N_LIMBS)]
    rhs = [out.limbs[i] + borrow * m_limbs[i] for i in range(N_LIMBS)]
    _enforce_integer_identity(ctx, q, lhs, rhs, name=f"{name}_id")
    return out
