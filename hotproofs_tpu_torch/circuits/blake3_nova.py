"""Nova step circuit: one IVC step of BLAKE3 leaf→root verification.

Capability equivalent of `Blake3Nova(D_FLAGS)`
(circuits/blake3_nova.circom:169-267) with the same 15-element public IO
layout as the reference's `Blake3CompressPubIO::to_vec`
(rust_fold/src/blake3_circuit.rs:111-123):

    [n_blocks, block_count, h[0..8], total_depth, depth,
     chunk_idx_low, chunk_idx_high, leaf_depth]

Step semantics (all matching the circom source):
  - is_root   = (depth == 0)                        (:19-23)
  - is_parent = depth < leaf_depth - 1              (:31-38)
  - in-circuit rejection of depth >= leaf_depth     (:41-44)
  - d-flags: CHUNK_START/CHUNK_END/PARENT/ROOT      (:122-167)
  - parent mode: h := IV, t := 0, message = running CV and sibling CV
    ordered by path direction                       (:229-245)
  - depth decrements when (chunk end or parent) and not root  (:254-262)

Deliberate redesign vs the reference:
  1. The path direction is a PRIVATE witness bit (`down_left`) instead of the
     chunk_idx bit-decomposition of Blake3GetDownLeftPath (:47-84). The leaf
     compression already binds the chunk's position via the t counter
     (t = chunk_idx, :244-245), so a wrong direction cannot reach the true
     root without a BLAKE3 collision — the direction is a hint, not a
     security input. This removes the 65-bit Num2Bits and, more importantly,
     fixes the reference's wrong-direction bug for non-power-of-two trees
     (rust_fold/src/main.rs:73 passes the leaf path depth as total_depth,
     which breaks Blake3GetDownLeftPath for shallow leaves; with a witness
     bit, arbitrary bao tree shapes fold correctly).
  2. The obsolete `override_h_to_IV` external input that the stale checked-in
     wasm expects (blake3_circuit.rs:260-265; absent from the circom source)
     is not reproduced: the h→IV mux is computed in-circuit from is_parent,
     as the circuit source does (:229-233).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence

import numpy as np

from ..core import blake3_ref as b3
from ..core.blake3_ref import IV, HashProof
from . import gadgets as g
from .blake3_compression import VESTA_PRIME, compression_gadget
from .dsl import compile_circuit, eval_witness

IO_ARITY = 15  # rust_fold/src/blake3_circuit.rs:15

# Flag constants (circuits/blake3_nova.circom:123-126).
FIRST_BLOCK_FLAG = 1
LAST_BLOCK_FLAG = 2
PARENT_FLAG = 4
ROOT_FLAG = 8

MAX_BLOCKS_PER_CHUNK = 16  # rust_fold/src/main.rs:25
MAX_BYTES_PER_BLOCK = 64


def declare_step_inputs(ctx):
    """The step function's own per-step inputs (shared by the standalone
    step circuit and the augmented recursive circuit, which must declare
    them during its IO phase)."""
    m_in = ctx.declare_input("m", 16, public=False)
    b_in = ctx.declare_input("b", 1, public=False)
    dl_in = ctx.declare_input("down_left", 1, public=False)
    return (m_in, b_in, dl_in)


def nova_step_body(ctx, z_in, extra, d_flags: int = 0,
                   depth_bits: int = 8):
    """The BLAKE3 chain-step transition as a pure gadget body:
    z_in values + (m, b, down_left) -> the 15 z_out expressions.
    Factored out of nova_step so circuits/nova_augmented.py can embed the
    SAME logic as the F of the recursive IVC (f_gadget).

    depth_bits: width of the depth/leaf_depth range decompositions.
    8 matches the reference (Num2Bits(8), blake3_nova.circom:25-29 — trees
    to depth 255); wider widths admit DEEPER paths, i.e. longer single
    chains (depth_bits=16 covers BASELINE config 5's 2^16-step chain).
    Strictly a superset: every 8-bit-valid statement stays valid."""
    m_in, b_in, dl_in = extra
    n_blocks, block_count = z_in[0], z_in[1]
    h_words = list(z_in[2:10])
    total_depth, depth = z_in[10], z_in[11]
    chunk_idx_low, chunk_idx_high = z_in[12], z_in[13]
    leaf_depth = z_in[14]
    b_word = b_in[0]
    down_left = dl_in[0]

    with ctx.scope("depth_check"):
        # Range checks mirroring Num2Bits(8) (blake3_nova.circom:25-29),
        # width-parameterised (see depth_bits above).
        g.tobits(ctx, depth, depth_bits, name="depth_bits")
        g.tobits(ctx, leaf_depth, depth_bits, name="leaf_depth_bits")
        is_root = g.is_zero(ctx, depth)
        is_parent = g.less_than(ctx, depth, leaf_depth - 1, depth_bits)
        # exceed_depth === 0 (:41-44) ⇔ depth < leaf_depth.
        in_range = g.less_than(ctx, depth, leaf_depth, depth_bits)
        ctx.enforce(0, 0, in_range - 1)

    with ctx.scope("flags"):
        not_parent = 1 - is_parent
        eq_first = g.is_zero(ctx, block_count)
        eq_last = g.is_equal(ctx, block_count, n_blocks - 1)
        first_set = g.mul(ctx, eq_first, not_parent, name="first_set")
        is_last_block = g.mul(ctx, eq_last, not_parent, name="last_block")
        # use_root = (is_parent OR eq_last) AND is_root (:151-158).
        par_or_last = is_parent + eq_last - g.mul(ctx, is_parent, eq_last,
                                                  name="par_and_last")
        use_root = g.mul(ctx, par_or_last, is_root, name="use_root")
        d_word = (d_flags
                  + FIRST_BLOCK_FLAG * first_set
                  + LAST_BLOCK_FLAG * is_last_block
                  + ROOT_FLAG * use_root
                  + PARENT_FLAG * is_parent)

    with ctx.scope("h_bits"):
        h = [g.to_u32(ctx, h_words[i], name=f"h{i}") for i in range(8)]

    with ctx.scope("message"):
        # Boolean-constrain the direction hint; leaves behave as down_left=1
        # (blake3_nova.circom:78-83).
        ctx.enforce(down_left, 1 - down_left, 0)
        dl = g.mux(ctx, is_parent, down_left, 1, name="dl_eff")
        m_eff: List = []
        for i in range(8):
            # Parent left child: running CV if descending left, else sibling.
            par_left = g.mux(ctx, dl, h_words[i], m_in[i], name=f"pl{i}")
            m_eff.append(g.mux(ctx, is_parent, par_left, m_in[i], name=f"me{i}"))
        for i in range(8, 16):
            par_right = g.mux(ctx, dl, m_in[i - 8], h_words[i - 8],
                              name=f"pr{i}")
            m_eff.append(g.mux(ctx, is_parent, par_right, m_in[i],
                               name=f"me{i}"))

    with ctx.scope("h_comp"):
        # Parents restart from IV (:229-233); bitwise mux against constant IV.
        h_comp: List[g.U32] = []
        for i in range(8):
            iv_bits = g.U32.const(IV[i]).bits
            bits = []
            for j in range(32):
                hb = h[i].bits[j]
                bits.append(g.mux(ctx, is_parent, int(iv_bits[j]), hb,
                                  name=f"hc{i}_{j}"))
            h_comp.append(g.U32(bits=bits))

    with ctx.scope("t"):
        # t masked to zero for parents (:244-245).
        t0 = g.mul(ctx, chunk_idx_low, not_parent, name="t0")
        t1 = g.mul(ctx, chunk_idx_high, not_parent, name="t1")

    with ctx.scope("compress"):
        out = compression_gadget(ctx, h_comp, m_eff, [t0, t1], b_word, d_word)

    with ctx.scope("update"):
        # decr = (last block OR parent) AND (not root) (:254-262); the OR is
        # exact because is_last_block has a (1-is_parent) factor.
        decr = g.mul(ctx, is_last_block + is_parent, 1 - is_root, name="decr")
        ctx.enforce(decr, 1 - decr, 0)

    return ([n_blocks, block_count + not_parent]
            + [out[i].word for i in range(8)]
            + [total_depth, depth - decr, chunk_idx_low, chunk_idx_high,
               leaf_depth])


def nova_step(ctx, d_flags: int = 0, depth_bits: int = 8) -> None:
    """Build/eval one step. Witness layout: [1, z_out(15), z_in(15),
    m(16), b(1), down_left(1), aux...]."""
    z_out = ctx.declare_output("z_out", IO_ARITY)
    z_in = ctx.declare_input("z_in", IO_ARITY, public=True)
    extra = declare_step_inputs(ctx)
    outs = nova_step_body(ctx, z_in, extra, d_flags, depth_bits)
    for o, v in zip(z_out, outs):
        ctx.bind(o, v)


@lru_cache(maxsize=None)
def get_nova_step_circuit(modulus: int = VESTA_PRIME, d_flags: int = 0,
                          depth_bits: int = 8):
    """Compile (once) and return (R1CS, layout) for the step circuit."""
    return compile_circuit(
        lambda ctx: nova_step(ctx, d_flags, depth_bits), modulus)


# ---------------------------------------------------------------------------
# Step scheduling: the host-side logic of Blake3BlockCompressCircuit
# (rust_fold/src/blake3_circuit.rs:56-195) — cursor rules and per-step
# private input formatting.
# ---------------------------------------------------------------------------


def n_blocks_from_bytes(n_bytes: int) -> int:
    """rust_fold/src/utils.rs:112-114, with n_blocks>=1 so empty chunks fold."""
    return max(1, (n_bytes + MAX_BYTES_PER_BLOCK - 1) // MAX_BYTES_PER_BLOCK)


@dataclass
class StepInputs:
    m: List[int]
    b: int
    down_left: int


@dataclass
class StepSchedule:
    """All per-step private inputs plus the z0 vector for one chunk proof."""

    z0: List[int]
    steps: List[StepInputs]
    n_blocks: int
    leaf_depth: int

    @property
    def num_steps(self) -> int:
        return len(self.steps)


def build_schedule(proof: HashProof) -> StepSchedule:
    """Derive the full fold schedule from a HashProof.

    Mirrors z0 construction (rust_fold/src/main.rs:130-145: h=IV, depth =
    leaf_depth-1, block_count=0), the leaf/parent input formatting
    (blake3_circuit.rs:197-289), and the cursor update rules (:185-195).
    num_steps = n_blocks + leaf_depth - 1 (main.rs:94)."""
    n_blocks = n_blocks_from_bytes(len(proof.chunk_bytes))
    leaf_depth = proof.leaf_depth
    z0 = ([n_blocks, 0] + list(IV)
          + [proof.total_depth, leaf_depth - 1,
             proof.chunk_idx & 0xFFFFFFFF, proof.chunk_idx >> 32, leaf_depth])

    steps: List[StepInputs] = []
    for blk in range(n_blocks):
        start = blk * MAX_BYTES_PER_BLOCK
        block = proof.chunk_bytes[start: start + MAX_BYTES_PER_BLOCK]
        steps.append(StepInputs(
            m=b3.words_from_block_bytes(block),
            b=len(block),
            down_left=1,
        ))
    # Parent steps walk the path leaf-side first (current_depth counts down
    # from leaf_depth-2 to 0; parent_path is stored root-side first).
    for level in range(len(proof.parent_path) - 1, -1, -1):
        node = proof.parent_path[level]
        steps.append(StepInputs(
            m=list(node.sibling_cv) + [0] * 8,
            b=MAX_BYTES_PER_BLOCK,
            down_left=1 if node.down_left else 0,
        ))
    assert len(steps) == n_blocks + leaf_depth - 1
    return StepSchedule(z0=z0, steps=steps, n_blocks=n_blocks,
                        leaf_depth=leaf_depth)


def eval_step_witness(z_in: Sequence[int], step: StepInputs,
                      modulus: int = VESTA_PRIME, d_flags: int = 0,
                      depth_bits: int = 8):
    """Host-side witness for one step; returns (witness_vector, z_out)."""
    r1cs, layout = get_nova_step_circuit(modulus, d_flags, depth_bits)
    w = eval_witness(
        lambda ctx: nova_step(ctx, d_flags, depth_bits), layout,
        {"z_in": list(z_in), "m": step.m, "b": [step.b],
         "down_left": [step.down_left]},
    )
    seg = layout.segment("z_out")
    z_out = [int(w[seg.start + i]) for i in range(IO_ARITY)]
    return w, z_out


def run_chain(proof: HashProof, modulus: int = VESTA_PRIME):
    """Walk the whole step chain on the host oracle path; returns the final z
    and all step witnesses. The extracted hash lives in z[2:10]
    (rust_fold/src/main.rs:195-201)."""
    sched = build_schedule(proof)
    z = [v % modulus for v in sched.z0]
    witnesses = []
    for step in sched.steps:
        w, z = eval_step_witness(z, step, modulus)
        witnesses.append(w)
    return z, witnesses, sched


def z_chain(proof: HashProof, modulus: int = VESTA_PRIME):
    """All public states [z_0 .. z_num_steps] of a chunk proof, host-side.

    The z evolution depends only on the hash chain (not on folds), so the
    whole chain is precomputable and every step witness can be generated in
    one batched device call (witness_jax.batched_nova_witness) — the
    structural parallelism the reference's sequential loop cannot express
    (rust_fold/src/main.rs:166-179)."""
    sched = build_schedule(proof)
    zs = [[v % modulus for v in sched.z0]]
    z = list(zs[0])
    for step in sched.steps:
        n_blocks, block_count = z[0], z[1]
        h = z[2:10]
        depth, leaf_depth = z[11], z[14]
        is_root = 1 if depth == 0 else 0
        is_parent = 1 if depth < leaf_depth - 1 else 0
        eq_last = 1 if block_count == n_blocks - 1 else 0
        d = 0
        if not is_parent:
            if block_count == 0:
                d |= b3.CHUNK_START
            if eq_last:
                d |= b3.CHUNK_END
        if is_parent:
            d |= b3.PARENT
        if is_root and (is_parent or eq_last):
            d |= b3.ROOT
        if is_parent:
            dl = step.down_left
            left = h if dl else step.m[:8]
            right = step.m[:8] if dl else h
            h_new = b3.compress(list(b3.IV), list(left) + list(right),
                                0, 64, d)[:8]
        else:
            t = (z[13] << 32) | z[12]
            h_new = b3.compress(h, step.m, t, step.b, d)[:8]
        is_last_block = eq_last * (1 - is_parent)
        decr = (is_last_block + is_parent) * (1 - is_root)
        z = [n_blocks, block_count + (1 - is_parent)] + list(h_new) + [
            z[10], depth - decr, z[12], z[13], leaf_depth]
        zs.append(z)
    return zs, sched
