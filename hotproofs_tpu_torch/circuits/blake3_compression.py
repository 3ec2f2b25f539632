"""BLAKE3 compression-function constraint system (bit-centric redesign).

Capability equivalent of the reference's `Blake3Compression` template
(circuits/blake3_compression.circom:171-228): same inputs (h[8], m[16], t[2],
b, d), same 16-word full output (out[0:8] = new CV, out[8:16] = upper state
XOR input h, :213-227), same 7-round / 8-G-mix / message-permutation
structure (:197-209).

Redesign vs the reference (see gadgets.py docstring): the v-state is carried
as bit-vectors; adds recompose words linearly and split through Bits33/34;
XOR against constant IV bits is free. The resulting system is ~17k
constraints vs the reference's ~49k (69,380 signals,
build/blake3_compression/blake3_compression.sym).

Message words `m` and byte-count `b` are deliberately NOT range-checked:
they only enter additively and every add is immediately reduced mod 2^32 by
a carry split, so any out-of-range component is absorbed into discarded
carry bits — the in-circuit function factors through m mod 2^32 and no
binding property depends on them (they are private witness). `t`, `b` and
`d` words are range-checked by their ToBits decomposition into the state.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

from ..core.blake3_ref import IV, MSG_PERMUTATION
from . import gadgets as g
from .dsl import R1CS, CircuitLayout, Value, compile_circuit, eval_witness

# Right-rotation amounts of the G function, matching blake3
# (circuits/blake3_compression.circom:112-113 uses pairs (16,12) and (8,7)).
R1, R2, R3, R4 = 16, 12, 8, 7

# Circuit field for the Pasta configuration: Vesta prime == Pallas scalar
# field (the reference builds with `--prime vesta`, package.json:27).
VESTA_PRIME = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
# BN254 scalar field (the reference's default build, package.json:26).
BN254_PRIME = 21888242871839275222246405745257275088548364400416034343698204186575808495617

G_SCHEDULE = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)


def g_mix(ctx, state: List[g.U32], a: int, b: int, c: int, d: int,
          mx: Value, my: Value) -> None:
    """One G mixing step, updating state in place.

    Mirrors MixFunG/HalfFunG (circuits/blake3_compression.circom:72-123) with
    the bit-centric representation: each add is a Bits34/Bits33 carry split,
    each xor+rotate costs <=32 constraints and free wiring.
    """
    va, vb, vc, vd = state[a], state[b], state[c], state[d]

    bits, _ = g.bits_split(ctx, va.word + vb.word + mx, 32, 2, name="ga")
    va = g.U32(bits=bits)
    vd = g.rotr(g.xor_u32(ctx, vd, va), R1)
    bits, _ = g.bits_split(ctx, vc.word + vd.word, 32, 1, name="gc")
    vc = g.U32(bits=bits)
    vb = g.rotr(g.xor_u32(ctx, vb, vc), R2)
    bits, _ = g.bits_split(ctx, va.word + vb.word + my, 32, 2, name="ga2")
    va = g.U32(bits=bits)
    vd = g.rotr(g.xor_u32(ctx, vd, va), R3)
    bits, _ = g.bits_split(ctx, vc.word + vd.word, 32, 1, name="gc2")
    vc = g.U32(bits=bits)
    vb = g.rotr(g.xor_u32(ctx, vb, vc), R4)

    state[a], state[b], state[c], state[d] = va, vb, vc, vd


def compression_gadget(ctx, h: Sequence[g.U32], m: Sequence[Value],
                       t: Sequence[Value], b: Value, d: Value) -> List[g.U32]:
    """Core compression over pre-decomposed h bits; returns 16 output words.

    State init mirrors circuits/blake3_compression.circom:184-187; the round
    and permutation chain mirrors :197-209; the output XOR mirrors :213-227.
    """
    with ctx.scope("init"):
        state: List[g.U32] = list(h)
        state += [g.U32.const(IV[i]) for i in range(4)]
        state.append(g.to_u32(ctx, t[0], name="t0"))
        state.append(g.to_u32(ctx, t[1], name="t1"))
        state.append(g.to_u32(ctx, b, name="b"))
        state.append(g.to_u32(ctx, d, name="d"))

    msg = list(m)
    for rnd in range(7):
        with ctx.scope(f"round{rnd}"):
            for gi, (ia, ib, ic, id_) in enumerate(G_SCHEDULE):
                with ctx.scope(f"g{gi}"):
                    g_mix(ctx, state, ia, ib, ic, id_,
                          msg[2 * gi], msg[2 * gi + 1])
        if rnd < 6:
            msg = [msg[p] for p in MSG_PERMUTATION]

    with ctx.scope("out"):
        out: List[g.U32] = []
        for i in range(8):
            out.append(g.xor_u32(ctx, state[i], state[i + 8]))
        for i in range(8, 16):
            out.append(g.xor_u32(ctx, state[i], h[i - 8]))
    return out


def standalone_compression(ctx) -> None:
    """The standalone circuit: public outputs out[16]; private h/m/t/b/d.

    Matches the IO shape of circuits/main/blake3_compression.circom:6 (only
    `out` public, Groth16 nPublic=16 per build/blake3_compression/
    groth16_vkey.json:4).
    """
    out_sigs = ctx.declare_output("out", 16)
    h_in = ctx.declare_input("h", 8, public=False)
    m_in = ctx.declare_input("m", 16, public=False)
    t_in = ctx.declare_input("t", 2, public=False)
    b_in = ctx.declare_input("b", 1, public=False)
    d_in = ctx.declare_input("d", 1, public=False)

    with ctx.scope("h_bits"):
        h = [g.to_u32(ctx, h_in[i], name=f"h{i}") for i in range(8)]
    out = compression_gadget(ctx, h, list(m_in), list(t_in), b_in[0], d_in[0])
    for i in range(16):
        ctx.bind(out_sigs[i], out[i].word)


@lru_cache(maxsize=None)
def get_compression_circuit(modulus: int = VESTA_PRIME):
    """Compile (once) and return (R1CS, layout) for the standalone circuit."""
    return compile_circuit(standalone_compression, modulus)


def compression_witness(h: Sequence[int], m: Sequence[int], t: Sequence[int],
                        b: int, d: int, modulus: int = VESTA_PRIME):
    """Host-side witness generation (oracle path; the batched TPU witness
    kernel lives in witness_jax.py). Returns the full witness vector."""
    r1cs, layout = get_compression_circuit(modulus)
    return eval_witness(
        standalone_compression, layout,
        {"h": list(h), "m": list(m), "t": list(t), "b": [b], "d": [d]},
    )
