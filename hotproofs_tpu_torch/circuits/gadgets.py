"""R1CS gadget library — capability equivalent of the reference's circom
gadgets (circuits/blake3_common.circom:15-251 and the circomlib comparators
used by circuits/blake3_nova.circom:9-11), redesigned bit-centric.

Design note (vs the reference): circom's `XorWord2/XorWord3` re-decompose
words into bits at every use (blake3_common.circom:55-115), costing ~3
ToBits(32) per XOR. Here the hash state is carried as bit-vectors (``U32``)
end-to-end: XOR costs 32 rows, rotation is free re-indexing, and words are
recomposed linearly for the adds. This cuts the BLAKE3 compression constraint
system ~3x relative to the circom design, which shrinks every downstream
kernel (witness MSM, SpMV, fold) by the same factor.

All gadgets run under both DSL interpretations (BuildCtx/EvalCtx); any
build/eval divergence trips the eval-mode constraint assertions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

from .dsl import LinExpr, Value


def _bit_decomp_fn(n: int):
    return lambda v: [(v >> i) & 1 for i in range(n)]


class CBit(int):
    """A compile-time-constant bit. Distinguishable from signal values in
    BOTH DSL modes (eval-mode signal values are plain ints), so peephole
    decisions that skip allocation are mode-deterministic."""


@dataclass
class U32:
    """A 32-bit word held as 32 bit-values (index 0 = least significant).

    ``const_val`` is set when the word is a compile-time constant; its bits
    are ``CBit``s, letting XOR take the linear path deterministically."""

    bits: List[Value]
    const_val: Optional[int] = None

    @property
    def word(self) -> Value:
        acc: Value = 0
        for i, b in enumerate(self.bits):
            acc = acc + b * (1 << i)
        return acc

    @staticmethod
    def const(v: int) -> "U32":
        return U32(bits=[CBit((v >> i) & 1) for i in range(32)],
                   const_val=v & 0xFFFFFFFF)


def tobits(ctx, x: Value, n: int, name: str = "bits") -> List[Value]:
    """ToBits(n) (blake3_common.circom:142-154): booleanity + recomposition."""
    bits = ctx.hint_vec(_bit_decomp_fn(n), [x], n, name=name)
    for b in bits:
        ctx.enforce(b, 1 - b, 0)
    acc: Value = 0
    for i, b in enumerate(bits):
        acc = acc + b * (1 << i)
    ctx.enforce(0, 0, acc - x)
    return bits


def to_u32(ctx, x: Value, name: str = "w") -> U32:
    return U32(bits=tobits(ctx, x, 32, name=name))


def bits_split(ctx, x: Value, n_low: int, n_carry: int, name: str = "split"):
    """Bits33/34/65/66 generalization (blake3_common.circom:160-251):
    decompose x into n_low low bits plus n_carry discarded carry bits.
    Returns (low_bits, low_word_expr)."""
    n = n_low + n_carry
    bits = ctx.hint_vec(_bit_decomp_fn(n), [x], n, name=name)
    for b in bits:
        ctx.enforce(b, 1 - b, 0)
    acc: Value = 0
    for i, b in enumerate(bits):
        acc = acc + b * (1 << i)
    ctx.enforce(0, 0, acc - x)
    return bits[:n_low], sum_bits(bits[:n_low])


def sum_bits(bits: Sequence[Value]) -> Value:
    acc: Value = 0
    for i, b in enumerate(bits):
        acc = acc + b * (1 << i)
    return acc


def xor2(ctx, x: Value, y: Value) -> Value:
    """One-bit XOR (blake3_common.circom:42-50): out = x + y - 2xy.

    XOR against a constant bit is linear and allocates nothing."""
    if isinstance(x, CBit) and isinstance(y, CBit):
        return CBit(int(x) ^ int(y))
    if isinstance(x, CBit):
        x, y = y, x
    if isinstance(y, CBit):
        return x if int(y) == 0 else 1 - x
    out = ctx.hint(lambda a, b: a ^ b, [x, y], name="xor")
    ctx.enforce(2 * x, y, x + y - out)
    return out


def xor_u32(ctx, a: U32, b: U32) -> U32:
    cv = None
    if a.const_val is not None and b.const_val is not None:
        cv = a.const_val ^ b.const_val
    return U32(bits=[xor2(ctx, x, y) for x, y in zip(a.bits, b.bits)],
               const_val=cv)


def rotr(a: U32, r: int) -> U32:
    """Right-rotation by r — free re-indexing (blake3_compression.circom:29-47
    spends signals on this; here it is pure wiring)."""
    return U32(bits=[a.bits[(i + r) % 32] for i in range(32)],
               const_val=None if a.const_val is None
               else ((a.const_val >> r) | (a.const_val << (32 - r))) & 0xFFFFFFFF)


def mul(ctx, x: Value, y: Value, name: str = "mul") -> Value:
    out = ctx.hint(lambda a, b: a * b, [x, y], name=name)
    ctx.enforce(x, y, out)
    return out


def is_zero(ctx, x: Value) -> Value:
    """circomlib IsZero: out = 1 iff x == 0."""
    p = ctx.p
    inv = ctx.hint(lambda v: pow(v, p - 2, p) if v % p else 0, [x], name="inv")
    out = ctx.hint(lambda v: 1 if v % p == 0 else 0, [x], name="isz")
    ctx.enforce(x, inv, 1 - out)
    ctx.enforce(x, out, 0)
    return out


def is_equal(ctx, x: Value, y: Value) -> Value:
    return is_zero(ctx, x - y)


def less_than(ctx, x: Value, y: Value, n: int) -> Value:
    """circomlib LessThan(n): assumes x, y < 2^n; out = 1 iff x < y."""
    bits = ctx.hint_vec(_bit_decomp_fn(n + 1), [x + (1 << n) - y], n + 1,
                        name="lt")
    for b in bits:
        ctx.enforce(b, 1 - b, 0)
    acc: Value = 0
    for i, b in enumerate(bits):
        acc = acc + b * (1 << i)
    ctx.enforce(0, 0, acc - (x + (1 << n) - y))
    return 1 - bits[n]


def mux(ctx, sel: Value, on_true: Value, on_false: Value, name: str = "mux") -> Value:
    """sel ? on_true : on_false, sel assumed boolean. One constraint."""
    out = ctx.hint(
        lambda s, t, f: t if s else f, [sel, on_true, on_false], name=name)
    ctx.enforce(sel, on_true - on_false, out - on_false)
    return out
