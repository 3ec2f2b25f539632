"""In-circuit elliptic-curve gadgets over the circuit field (DSL).

Building block of the augmented IVC circuit: on a curve CYCLE (Pasta,
BN254/Grumpkin) each side's circuit verifies folds of instances committed
on the OTHER curve, whose point coordinates live in THIS circuit's field —
so every group operation here is native field arithmetic (the structural
trick behind arecibo's RecursiveSNARK; rust_fold inherits it via
arecibo 0.1.1, reference Cargo.toml:11).

Points are projective (X, Y, Z) DSL values; the formulas are the SAME
complete RCB15 a=0 algorithms as the device kernels (ops/curve.py:111-171),
so there is no incomplete-addition edge case to audit: identity, doubling
inputs and inverse pairs are all handled by the formula itself. Cost: one
complete add = 12 constraints, one doubling = 8 (additions and b3-scalings
are linear and free).

Scalar multiplication is double-and-add, MSB first, over an externally
supplied BIT decomposition of the scalar. In the augmented circuit the
scalar is a Fiat–Shamir challenge squeezed from the transcript sponge over
this same field; its booleanity + recomposition constraints live with the
caller (bits are shared between the hash check and the mult).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from . import gadgets as g
from .dsl import Value

EcPoint = Tuple[Value, Value, Value]   # projective (X, Y, Z)


def identity() -> EcPoint:
    return (0, 1, 0)


def add(ctx, b3: int, p: EcPoint, q: EcPoint, name: str = "ec_add") -> EcPoint:
    """Complete projective addition (RCB15 Algorithm 7, a=0); b3 = 3*b of
    the curve whose base field is the circuit field."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    mul = lambda a, b, n: g.mul(ctx, a, b, name=f"{name}_{n}")

    t0 = mul(X1, X2, "t0")
    t1 = mul(Y1, Y2, "t1")
    t2 = mul(Z1, Z2, "t2")
    t3 = mul(X1 + Y1, X2 + Y2, "t3")
    t3 = t3 - (t0 + t1)
    t4 = mul(Y1 + Z1, Y2 + Z2, "t4")
    t4 = t4 - (t1 + t2)
    X3 = mul(X1 + Z1, X2 + Z2, "x3a")
    Y3 = X3 - (t0 + t2)
    X3 = t0 + t0
    t0 = X3 + t0
    t2 = t2 * b3
    Z3 = t1 + t2
    t1 = t1 - t2
    Y3 = Y3 * b3
    X3 = mul(t4, Y3, "x3b")
    X3 = mul(t3, t1, "x3c") - X3
    Y3 = mul(t1, Z3, "y3a") + mul(Y3, t0, "y3b")
    Z3 = mul(Z3, t4, "z3a") + mul(t0, t3, "z3b")
    return (X3, Y3, Z3)


def double(ctx, b3: int, p: EcPoint, name: str = "ec_dbl") -> EcPoint:
    """Complete projective doubling (RCB15 Algorithm 9, a=0)."""
    X, Y, Z = p
    mul = lambda a, b, n: g.mul(ctx, a, b, name=f"{name}_{n}")

    t0 = mul(Y, Y, "t0")
    Z3 = t0 * 8
    t1 = mul(Y, Z, "t1")
    t2 = mul(Z, Z, "t2")
    t2 = t2 * b3
    X3 = mul(t2, Z3, "x3a")
    Y3 = t0 + t2
    Z3 = mul(t1, Z3, "z3")
    t1 = t2 + t2
    t2 = t1 + t2
    t0 = t0 - t2
    Y3 = mul(t0, Y3, "y3a")
    Y3 = X3 + Y3
    t1 = mul(X, Y, "t1b")
    X3 = mul(t0, t1, "x3b")
    X3 = X3 + X3
    return (X3, Y3, Z3)


def select(ctx, sel: Value, on_true: EcPoint, on_false: EcPoint,
           name: str = "ec_mux") -> EcPoint:
    """sel ? on_true : on_false, coordinatewise (sel boolean)."""
    return tuple(g.mux(ctx, sel, a, b, name=f"{name}_{i}")
                 for i, (a, b) in enumerate(zip(on_true, on_false)))


def scalar_mul(ctx, b3: int, bits_le: Sequence[Value], p: EcPoint,
               name: str = "ec_smul") -> EcPoint:
    """[k]P by double-and-add over k's little-endian boolean bits.

    23 constraints per bit (8 double + 12 add + 3 mux); the complete
    formulas make every intermediate (identity accumulator, doubling
    collisions) well-defined, so no special-casing is needed."""
    acc = identity()
    for i, bit in enumerate(reversed(list(bits_le))):   # MSB first
        acc = double(ctx, b3, acc, name=f"{name}_d{i}")
        added = add(ctx, b3, acc, p, name=f"{name}_a{i}")
        acc = select(ctx, bit, added, acc, name=f"{name}_m{i}")
    return acc


def assert_on_curve(ctx, b: int, p: EcPoint, name: str = "ec_chk") -> None:
    """Projective curve membership: Y^2 Z = X^3 + b Z^3. The identity
    (0, y, 0) satisfies it; combined with Z!=0 checks where needed."""
    X, Y, Z = p
    y2 = g.mul(ctx, Y, Y, name=f"{name}_y2")
    y2z = g.mul(ctx, y2, Z, name=f"{name}_y2z")
    x2 = g.mul(ctx, X, X, name=f"{name}_x2")
    x3 = g.mul(ctx, x2, X, name=f"{name}_x3")
    z2 = g.mul(ctx, Z, Z, name=f"{name}_z2")
    z3 = g.mul(ctx, z2, Z, name=f"{name}_z3")
    ctx.enforce(0, 0, y2z - (x3 + z3 * b))


def normalize_affine(ctx, p: EcPoint, name: str = "ec_aff"):
    """(x, y, is_infinity) from projective, via a hinted inverse of Z.

    zinv is a HINT; soundness: z*zinv == 1 - is_inf, is_inf boolean,
    is_inf * z == 0 (so z==0 <-> is_inf==1, and otherwise zinv is the true
    inverse). At infinity x = y = 0 by construction."""
    X, Y, Z = p
    pmod = ctx.p
    zinv = ctx.hint(lambda z: pow(z, pmod - 2, pmod), [Z],
                    name=f"{name}_zinv")
    is_inf = ctx.hint(lambda z: 1 if z % pmod == 0 else 0, [Z],
                      name=f"{name}_inf")
    ctx.enforce(is_inf, is_inf, is_inf)            # boolean
    ctx.enforce(is_inf, Z, 0)                      # inf -> Z == 0
    ctx.enforce(Z, zinv, 1 - is_inf)               # else zinv = Z^-1
    x = g.mul(ctx, X, zinv, name=f"{name}_x")
    y = g.mul(ctx, Y, zinv, name=f"{name}_y")
    return x, y, is_inf
