"""The augmented IVC circuit: an in-circuit Nova fold verifier.

This is the capability arecibo's RecursiveSNARK provides the reference
(rust_fold/src/main.rs:151-193): each step's circuit verifies the fold of
the OTHER curve's running instance, making the final verifier O(1) —
constant state, no per-step replay. Built from this stack's own gadgets:
poseidon_gadget (transcript), ec_gadget (native-curve group ops),
bignat_gadget (the other field's scalars).

Two instantiations on a curve cycle (Pasta here, BN254/Grumpkin works the
same): C1 over F_q runs the user step F and folds SECONDARY instances
(committed on Vesta — point coords in F_q, native); C2 over F_p is trivial
and folds PRIMARY instances (Pallas points, coords in F_p, native).

## Wiring ("echo binding")

Each strict instance carries TWO public IO slots:
    u1_k.X = [ H_q(vk, k, z0, z_k, U2_k),  echo = u2_k.X[0] ]
    u2_k.X = [ H_p(vk, k, U1_k),           echo = u1_{k-1}.X[0] ]
Step k: C2_k folds u1_{k-1} into U1_{k-1} -> U1_k and checks natively
    u1_{k-1}.X[1] == H_p(vk, k-1, U1_{k-1});
C1_k folds the SAME-step u2_k into U2_{k-1} -> U2_k and checks natively
    u2_k.X[1] == H_q(vk, k-1, z0, z_{k-1}, U2_{k-1});
each circuit echoes the folded instance's X[0] into its own X[1]. Base
case (k-1 == 0): the hash check is skipped and the circuit instead pins
z_prev == z0 / U_prev == default; C2_1 skips its fold (there is no u1_0).

Soundness induction (verifier checks u1_n.X[0] == H_q(vk,n,z0,z_n,U2_n),
u1_n.X[1] == H_p(vk,n,U1_n), plus satisfiability of U1_n, U2_n, u1_n):
sat(u1_n) gives C1_n's relation; fold knowledge-soundness of sat(U2_n)
gives sat(u2_n); C2_n's relation then pins U1_n (via H_p collision
resistance against check 2) and re-establishes BOTH invariant hashes for
step n-1, plus sat(U1_{n-1}), sat(u1_{n-1}) — recursing to the base.

Cross-field values (hashes echoed between fields, fold scalars) are
truncated to 250 bits so they are unambiguous integers in both fields;
in-circuit challenge derivation decomposes the squeezed element into a
CANONICAL (alias-checked < modulus) 255-bit string and keeps the low 250.
The composed-echo wrap-around cheat (witnessing X[0]+p) is killed by the
strict instance's own R1CS binding its IO exactly (see docs/AUGMENTED.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from ..ops import poseidon as P
from . import bignat_gadget as BN
from . import ec_gadget as E
from . import gadgets as g
from .dsl import Value

CHALLENGE_BITS = 250

# Domain tags for the two sponge uses (native field element derived from
# these ints by the caller's spec; kept small + distinct).
TAG_STATE = 0x68705F7374617465   # "hp_state"
TAG_FOLD = 0x68705F666F6C6400    # "hp_fold"


@dataclass
class RelaxedVar:
    """In-circuit running relaxed instance of the OTHER side."""

    comm_W: tuple      # (x, y, inf) native affine
    comm_E: tuple
    u: BN.BigNat       # foreign scalars
    X0: BN.BigNat
    X1: BN.BigNat


@dataclass
class StrictVar:
    """In-circuit strict instance of the other side (u = 1, E = 0)."""

    comm_W: tuple
    X0: BN.BigNat
    X1: BN.BigNat


def _affine_to_proj(ctx, pt, name: str):
    """(x, y, inf) -> projective (X, Y, Z): identity when inf."""
    x, y, inf = pt
    X = g.mux(ctx, inf, 0, x, name=f"{name}_px")
    Y = g.mux(ctx, inf, 1, y, name=f"{name}_py")
    Z = 1 - inf
    return (X, Y, Z)


def _check_point(ctx, b: int, pt, name: str) -> None:
    """Witnessed-affine-point validity: inf boolean; inf => x = y = 0;
    else on-curve (y^2 = x^3 + b)."""
    x, y, inf = pt
    ctx.enforce(inf, inf, inf)
    ctx.enforce(inf, x, 0)
    ctx.enforce(inf, y, 0)
    y2 = g.mul(ctx, y, y, name=f"{name}_y2")
    x2 = g.mul(ctx, x, x, name=f"{name}_x2")
    x3 = g.mul(ctx, x2, x, name=f"{name}_x3")
    ctx.enforce(1 - inf, y2 - x3 - b, 0)


def canonical_bits(ctx, v: Value, name: str = "cb") -> List[Value]:
    """n_bits LE decomposition of a native element (n_bits = |p|, 255 for
    Pasta / 254 for BN254-Grumpkin), alias-checked < p (two-half
    lexicographic comparison), so the bitstring is the unique canonical
    representation. Returns all n_bits bits."""
    p = ctx.p
    n_bits = p.bit_length()
    assert n_bits >= CHALLENGE_BITS + 1, "field too small for challenges"
    bits = g.tobits(ctx, v, n_bits, name=name)
    lo = sum_pow2(bits[:128])
    hi = sum_pow2(bits[128:])
    p_lo = p & ((1 << 128) - 1)
    p_hi = p >> 128
    hi_lt = g.less_than(ctx, hi, p_hi, n_bits - 128)
    hi_eq = g.is_equal(ctx, hi, p_hi)
    lo_lt = g.less_than(ctx, lo, p_lo, 129)
    both = g.mul(ctx, hi_eq, lo_lt, name=f"{name}_and")
    ctx.enforce(0, 0, hi_lt + both - g.mul(ctx, hi_lt, both,
                                           name=f"{name}_or") - 1)
    return bits


def sum_pow2(bits: Sequence[Value]) -> Value:
    acc: Value = 0
    for i, b in enumerate(bits):
        acc = acc + b * (1 << i)
    return acc


class SpongeAbsorbers:
    """Absorb-encoding shared by circuit and host mirror (nova/recursive.py
    mirrors these sequences exactly — any drift breaks the transcripts)."""

    @staticmethod
    def point(sp, pt) -> None:
        x, y, inf = pt
        sp.absorb([x, y, inf])

    @staticmethod
    def bignat(sp, bn: BN.BigNat) -> None:
        sp.absorb(list(bn.limbs))

    @classmethod
    def relaxed(cls, sp, U: RelaxedVar) -> None:
        cls.point(sp, U.comm_W)
        cls.point(sp, U.comm_E)
        cls.bignat(sp, U.u)
        cls.bignat(sp, U.X0)
        cls.bignat(sp, U.X1)

    @classmethod
    def strict(cls, sp, u: StrictVar) -> None:
        cls.point(sp, u.comm_W)
        cls.bignat(sp, u.X0)
        cls.bignat(sp, u.X1)


def fold_gadget(ctx, pspec: P.PoseidonSpec, b3: int, m: int, vk: Value,
                U: RelaxedVar, u: StrictVar, T_bar,
                name: str = "fold") -> RelaxedVar:
    """In-circuit NIFS.V: derive r from the fold RO, fold commitments
    (native EC) and scalars (foreign BigNat). Returns U'."""
    from .poseidon_gadget import SpongeGadget

    sp = SpongeGadget(ctx, pspec, domain_tag=TAG_FOLD)
    sp.absorb([vk])
    SpongeAbsorbers.relaxed(sp, U)
    SpongeAbsorbers.strict(sp, u)
    SpongeAbsorbers.point(sp, T_bar)
    r_full = sp.squeeze()
    r_bits = canonical_bits(ctx, r_full, name=f"{name}_rb")[:CHALLENGE_BITS]

    # Native group folds.
    def fold_pt(acc_pt, add_pt, nm):
        scaled = E.scalar_mul(ctx, b3, r_bits,
                              _affine_to_proj(ctx, add_pt, nm), name=nm)
        s = E.add(ctx, b3, _affine_to_proj(ctx, acc_pt, nm + "a"), scaled,
                  name=nm + "s")
        return E.normalize_affine(ctx, s, name=nm + "n")

    comm_W = fold_pt(U.comm_W, u.comm_W, f"{name}_w")
    comm_E = fold_pt(U.comm_E, T_bar, f"{name}_e")

    # Foreign scalar folds: r as a foreign element (< 2^250 < m).
    r_bn = BN.from_bits(ctx, r_bits, name=f"{name}_rbn")
    u_out = BN.add_mod(ctx, m, U.u, r_bn, name=f"{name}_u")
    X0 = BN.add_mod(ctx, m, U.X0,
                    BN.mul_mod(ctx, m, r_bn, u.X0, name=f"{name}_x0m"),
                    name=f"{name}_x0")
    X1 = BN.add_mod(ctx, m, U.X1,
                    BN.mul_mod(ctx, m, r_bn, u.X1, name=f"{name}_x1m"),
                    name=f"{name}_x1")
    return RelaxedVar(comm_W=comm_W, comm_E=comm_E, u=u_out, X0=X0, X1=X1)


def state_hash(ctx, pspec: P.PoseidonSpec, vk: Value, k: Value,
               z_vals: Optional[Sequence[Value]],
               z0_vals: Optional[Sequence[Value]],
               U: RelaxedVar) -> Value:
    """H(vk, k, [z0, z], U) over the native sponge. z absent on the
    trivial side (C2 binds only the running primary instance)."""
    from .poseidon_gadget import SpongeGadget

    sp = SpongeGadget(ctx, pspec, domain_tag=TAG_STATE)
    sp.absorb([vk, k])
    if z0_vals is not None:
        sp.absorb(list(z0_vals))
    if z_vals is not None:
        sp.absorb(list(z_vals))
    SpongeAbsorbers.relaxed(sp, U)
    return sp.squeeze()


def _truncate_to_bits(ctx, v: Value, name: str) -> List[Value]:
    """Canonical 255-bit decomposition, low CHALLENGE_BITS returned; the
    high bits are part of the decomposition but unused (truncation)."""
    return canonical_bits(ctx, v, name=name)[:CHALLENGE_BITS]


def _declare_relaxed(ctx, prefix: str) -> RelaxedVar:
    pw = ctx.declare_input(f"{prefix}_cw", 3, public=False)
    pe = ctx.declare_input(f"{prefix}_ce", 3, public=False)
    u = ctx.declare_input(f"{prefix}_u", BN.N_LIMBS, public=False)
    x0 = ctx.declare_input(f"{prefix}_x0", BN.N_LIMBS, public=False)
    x1 = ctx.declare_input(f"{prefix}_x1", BN.N_LIMBS, public=False)
    return RelaxedVar(comm_W=tuple(pw), comm_E=tuple(pe),
                      u=BN.BigNat(list(u)), X0=BN.BigNat(list(x0)),
                      X1=BN.BigNat(list(x1)))


def _declare_strict(ctx, prefix: str) -> StrictVar:
    pw = ctx.declare_input(f"{prefix}_cw", 3, public=False)
    x0 = ctx.declare_input(f"{prefix}_x0", BN.N_LIMBS, public=False)
    x1 = ctx.declare_input(f"{prefix}_x1", BN.N_LIMBS, public=False)
    return StrictVar(comm_W=tuple(pw), X0=BN.BigNat(list(x0)),
                     X1=BN.BigNat(list(x1)))


def make_augmented_circuit(pspec: P.PoseidonSpec, b: int, m: int,
                           vk_value: int, arity: int,
                           f_gadget: Optional[Callable],
                           fold_at_base: bool,
                           f_extra_decl: Optional[Callable] = None):
    """Build the augmented circuit gadget.

    pspec: Poseidon spec over THIS circuit's field. b: coefficient of the
    OTHER curve (whose base field is this field); b3 = 3b. m: the other
    circuit's field modulus. arity: z-state length (0 on the trivial
    side). f_gadget(ctx, z_prev, extra) -> z_next, or None for trivial (z
    passes through). f_extra_decl(ctx) -> extra declares the step
    function's own per-step inputs (e.g. the BLAKE3 message block) during
    the IO-declaration phase — the DSL freezes IO at the first aux
    allocation, so F cannot declare inputs itself. fold_at_base: True for
    C1 (folds the same-step u2 even at k=1), False for C2 (no u1_0
    exists; base outputs U_prev = default).

    IO: out[0] = H(vk, k, [z0, z_k], U_next); out[1] = echo (the folded
    strict instance's X[0], composed to a native element).
    """
    b3 = (3 * b)

    def circuit(ctx):
        out = ctx.declare_output("x", 2)
        k_prev = ctx.declare_input("k_prev", 1, public=False)[0]
        if arity:
            z0 = ctx.declare_input("z0", arity, public=False)
            z_prev = ctx.declare_input("z_prev", arity, public=False)
        else:
            z0, z_prev = None, None
        U_prev = _declare_relaxed(ctx, "U")
        u_other = _declare_strict(ctx, "u")
        tb = ctx.declare_input("T_cw", 3, public=False)
        T_bar = tuple(tb)
        extra = f_extra_decl(ctx) if f_extra_decl is not None else None

        vk = vk_value % ctx.p
        is_base = g.is_zero(ctx, k_prev)

        # Witnessed-value validity.
        _check_point(ctx, b, U_prev.comm_W, "Ucw")
        _check_point(ctx, b, U_prev.comm_E, "Uce")
        _check_point(ctx, b, u_other.comm_W, "ucw")
        _check_point(ctx, b, T_bar, "Tcw")
        for bn, nm in ((U_prev.u, "Uu"), (U_prev.X0, "Ux0"),
                       (U_prev.X1, "Ux1"), (u_other.X0, "ux0"),
                       (u_other.X1, "ux1")):
            for i, l in enumerate(bn.limbs):
                g.tobits(ctx, l, BN.LIMB_BITS, name=f"rc_{nm}{i}")
            BN.assert_less_than_m(ctx, bn, m, name=f"ltm_{nm}")

        # Base-case pinning: z_prev == z0, U_prev == default.
        if arity:
            for a_, b_ in zip(z_prev, z0):
                ctx.enforce(is_base, a_ - b_, 0)
        for x, y, inf in (U_prev.comm_W, U_prev.comm_E):
            ctx.enforce(is_base, x, 0)
            ctx.enforce(is_base, y, 0)
            ctx.enforce(is_base, 1 - inf, 0)
        for bn in (U_prev.u, U_prev.X0, U_prev.X1):
            for l in bn.limbs:
                ctx.enforce(is_base, l, 0)

        # Non-base: the folded strict instance's echo slot must equal the
        # NATIVE state hash of the previous step (limbwise on the
        # truncated bits -> no cross-field wrap).
        h_check = state_hash(ctx, pspec, vk, k_prev, z_prev, z0, U_prev)
        h_bits = _truncate_to_bits(ctx, h_check, name="hchk")
        h_bn = BN.from_bits(ctx, h_bits, name="hchk_bn")
        for lc, lu in zip(h_bn.limbs, u_other.X1.limbs):
            ctx.enforce(1 - is_base, lc - lu, 0)

        # Fold (always synthesized; discarded via mux when base && !fold_at_base).
        U_folded = fold_gadget(ctx, pspec, b3, m, vk, U_prev, u_other,
                               T_bar)
        if fold_at_base:
            U_next = U_folded
        else:
            def mux_pt(p_t, p_f, nm):
                return tuple(g.mux(ctx, is_base, a_, b_, name=f"{nm}{i}")
                             for i, (a_, b_) in enumerate(zip(p_t, p_f)))

            def mux_bn(b_t, b_f, nm):
                return BN.BigNat([
                    g.mux(ctx, is_base, a_, b_, name=f"{nm}{i}")
                    for i, (a_, b_) in enumerate(zip(b_t.limbs, b_f.limbs))])

            U_next = RelaxedVar(
                comm_W=mux_pt(U_prev.comm_W, U_folded.comm_W, "mxw"),
                comm_E=mux_pt(U_prev.comm_E, U_folded.comm_E, "mxe"),
                u=mux_bn(U_prev.u, U_folded.u, "mxu"),
                X0=mux_bn(U_prev.X0, U_folded.X0, "mx0"),
                X1=mux_bn(U_prev.X1, U_folded.X1, "mx1"))

        # Step function.
        if f_gadget is not None:
            z_next = f_gadget(ctx, list(z_prev), extra)
        else:
            z_next = z_prev

        # Outputs.
        h_out = state_hash(ctx, pspec, vk, k_prev + 1, z_next, z0, U_next)
        h_out_bits = _truncate_to_bits(ctx, h_out, name="hout")
        ctx.bind(out[0], sum_pow2(h_out_bits))
        echo = u_other.X0.value_expr(
            [pow(2, BN.LIMB_BITS * i, ctx.p) for i in range(BN.N_LIMBS)])
        ctx.bind(out[1], echo)

    return circuit
