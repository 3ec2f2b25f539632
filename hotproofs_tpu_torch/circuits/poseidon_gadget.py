"""In-circuit Poseidon permutation + transcript sponge (DSL gadgets).

The building block of the augmented IVC circuit (arecibo's RecursiveSNARK
verifies each fold *inside* the next step's circuit; the fold challenge is a
Poseidon evaluation — SURVEY.md §2b "neptune"). These gadgets mirror
ops/poseidon.py's host sponge EXACTLY (same PoseidonSpec constants, same
rate-2 duplex schedule), so an in-circuit transcript replay produces the
same challenges the host prover derived.

Cost: one permutation = R_F*t + R_P = 8*3 + 57 = 81 s-box lanes, 2 rank-1
constraints each (x2 = x*x guarded by x4 = x2*x2 then x5 = x4*x) -> 243
constraints. The MDS layer and round-constant additions are linear and cost
nothing (they fold into LinExpr coefficient arithmetic); after k partial
rounds the passive lanes are ~k-term linear combinations, which the COO
builder normalizes into one sparse row per constraint.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ops import poseidon as P
from . import gadgets as g
from .dsl import LinExpr, Value


def _norm(ctx, v: Value) -> Value:
    """Collapse a LinExpr's term list (dedupe signal indices mod p).

    The partial-round MDS layer feeds lanes 1 and 2 back into themselves:
    without normalization their symbolic term TUPLES double every round
    (2^57-term expressions by the last partial round). Deduped, a lane is a
    combination of at most one signal per past round. Eval-mode values are
    plain ints — nothing to do."""
    if not isinstance(v, LinExpr):
        return v
    acc = {}
    for i, c in v.terms:
        acc[i] = (acc.get(i, 0) + c) % ctx.p
    return LinExpr(tuple((i, c) for i, c in acc.items() if c),
                   v.const % ctx.p)


def permute(ctx, spec: P.PoseidonSpec, state: Sequence[Value]) -> List[Value]:
    """One Poseidon permutation over DSL values; mirrors host_permute."""
    assert ctx.p == spec.field.p, "Poseidon spec field != circuit field"
    assert len(state) == spec.t
    half = spec.r_full // 2
    s = list(state)

    def sbox(x: Value, name: str) -> Value:
        x2 = g.mul(ctx, x, x, name=name + "_2")
        x4 = g.mul(ctx, x2, x2, name=name + "_4")
        return g.mul(ctx, x4, x, name=name + "_5")

    for rnd in range(spec.n_rounds):
        s = [si + c for si, c in zip(s, spec.round_constants[rnd])]
        is_full = rnd < half or rnd >= half + spec.r_partial
        if is_full:
            s = [sbox(si, f"r{rnd}l{i}") for i, si in enumerate(s)]
        else:
            s[0] = sbox(s[0], f"r{rnd}l0")
        s = [_norm(ctx, sum((m * si for m, si in zip(row, s)), 0))
             for row in spec.mds]
    return s


class SpongeGadget:
    """In-circuit duplex sponge, bit-compatible with ops/poseidon.HostSponge
    (t=3, rate 2: absorb adds into rate lanes in pairs, permuting after each
    pair; squeeze pads with a permute on an odd boundary, permutes, returns
    lane 1)."""

    def __init__(self, ctx, spec: P.PoseidonSpec, domain_tag: int):
        self.ctx = ctx
        self.spec = spec
        self.state: List[Value] = [domain_tag % ctx.p, 0, 0]
        self._absorbed = 0

    def absorb(self, vals: Sequence[Value]) -> None:
        rate = self.spec.t - 1
        for v in vals:
            lane = 1 + (self._absorbed % rate)
            self.state[lane] = self.state[lane] + v
            self._absorbed += 1
            if self._absorbed % rate == 0:
                self.state = permute(self.ctx, self.spec, self.state)

    def squeeze(self) -> Value:
        if self._absorbed % (self.spec.t - 1) != 0:
            self.state = permute(self.ctx, self.spec, self.state)
            self._absorbed = 0
        self.state = permute(self.ctx, self.spec, self.state)
        return self.state[1]
