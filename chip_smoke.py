"""On-card smoke test of the PyTorch/CUDA port (hotproofs_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, one or more lines each; any failure ends the run with a non-zero
exit and no result line:
  1. the card (nvidia-smi name and power limit) and the toolchain;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and time the build;
  3. each kernel against its plain torch version on the card, on seeded
     inputs (exact integer equality; the merge with several blocks per slot
     over lanes no multiple of them, a sparse batch whose buckets are
     mostly empty, and a job of zero scalars whose buckets and slots must
     all be the identity; to_affine over 3 1/4 blocks with zero Z's at a
     point, a thread, a block; msm_wsum at S = 1..32 and J = 0..256 with
     identity slots), then kernel and plain times at the main path's
     shapes, msm_wsum's critical path in dependent adds and its time an
     add, and to_affine's time on one block (one Fermat chain's latency);
  4. the main path at full circuit size: ChunkProver(device="cuda") proves
     one chunk of a 64 MiB file (depth 16), verifies it against the BLAKE3
     oracle's root, proves two chunks in lockstep (prove_many), verifies
     both, and rejects a proof with one comm_T changed;
  5. each kernel's launch count during phase 4 (every one must be > 0);
  6. the MSM bucket designs (tools/msm_designs.py): msm_chain (at H = 1,
     msm_bucket's thread map, and at the H of ops/msm_pallas.py:
     chain_split), msm_bucket_tsplit and msm_bucket_signed (both on
     msm_bucket's sorted walk over the key's lane-major bases) and the 8-slot merge and wsum
     against their plain versions (seeded, m = 1000, 40 and 256 bits, then
     at the comm_T shape, exact equality, kernel and plain times), then
     the designs path at the comm_T J=1, W J=16, W J=256 and comm_T J=16
     shapes: per shape
     the production stages' times, its digit statistics (nonzero share per
     window, touched share of the (lane, bucket) entries, adds per warp in
     lockstep against the sorted walk), the whole msm_many at B = 64, 32
     and 16, and one line per design with its time and its
     check; then the design kernels' launch counts during that run (every
     one must be > 0);
  7. the field-multiply path (tools/field_mul.py): mont_mul in its three
     formats and with broadcast operands, mont_mul_stage (stages 1..5),
     mont_mul_part (conv, conv3, norm) and conv_mma against their plain
     versions in three fields, on seeded inputs with the edge lanes 0 * 0,
     (p-1)^2 and 1 * (p-1), at a size that is no multiple of 512 (exact
     equality); mont_mul at the prover's own to_mont and from_mont shapes;
     then the tool's run at N = 16,384 and 131,072, one line per kernel,
     stage and part with its time, its plain version's and its bound, the
     library call for conv_mma (a grouped float32 conv1d without TF32,
     timed the same way; its library_ms where its columns equal
     conv_mma's), and the launch counts of that run (every one must be
     > 0);
  8. vk and segments, with the launch counts set to 0 before it: the
     phase-4 prover's verification key is exported, phase 4's proof
     verified from it alone (nova/vk.py) and a vk with one matrix value
     changed refused; phase 4's chunk is proved as 4 segments
     (prove_segmented: in lockstep, then on the thread pool with the same
     bytes) and verified, segment 2 byte-equal to a standalone prove_batch
     over its steps, a swapped pair refused; the
     reference's proof of a 2-block chunk (tests/data) verifies and the
     port's proof of that chunk equals it byte for byte; a 1,024-step chain
     on the depth-13 circuit (tools/longchain_deep.py) is proved as 8
     segments in lockstep waves of 4, stopped after wave 1 and run again on
     the same checkpoints (4 resumed, 4 proved), and verified to its
     published root; then the launch counts of the phase (msm_bucket,
     msm_merge, msm_wsum and mont_mul must be > 0) and the span timers
     of segments/lockstep_wave and segments/prove_one (one a pool
     segment: at least 4); last, msm_bucket,
     msm_merge, msm_wsum and mont_mul against their plain versions on the
     inputs of the first MSM and to_mont call of each shape, scalars not
     all zero, that the segment runs gave them (exact equality);
  9. Spartan compression (nova/spartan.py), with the launch counts set to
     0 before it: the phase-4 prover's SpartanSystem set up (its matrix
     tables built by h_tables or loaded from the disk cache, then laid out
     on the card with the key's bases at the IPAs' lengths), a second one
     that loads the tables, compress and verify_compressed of phase 4's
     proof with the time of each part, the IPA rounds and the sizes of
     both proof files, four tampers refused (vL, a sum-check evaluation,
     an IPA L point, a dropped sum-check round), a cached table with a
     changed digest refused and rebuilt, the CLI's prove --compress and
     verify, the reference's toy and wide compressed proofs (tests/data)
     accepted and the port's byte-equal to them, the reference's real-size
     chunk proof compressed and verified; then the launch counts of setup,
     compress and verify (every main-path kernel and scale16 must be > 0;
     after setup, compress and verify must launch no scale16 and no
     to_affine, and msm_bucket once per IPA round and once for the
     commitment to L), scale16 against its plain version on the inputs
     setup gave it (and a slice of its affine windows against the host's
     16^w P), timed beside its bound, and each round of the first
     IPA (its J = 2 commit over the key's prepared bases beside the MSM's
     bound, and its two mont_mul) timed on the scalars the compress gave
     it, with the card's name and power limit beside every time;
 10. the recursive SNARK (nova/recursive.py), with the launch counts set
     to 0 before it: the phase-4 prover's RecursiveSNARK over the BLAKE3
     step (both augmented circuits at full width, the vk, both keys made
     and prepared on the card), prove_recursive of phase 4's chunk with
     each step's host synthesis, device and commit ms, verify_recursive
     against the root, the proof file's bytes, four tampers refused
     (chunk_idx, z_final, U1's comm_W and comm_E swapped, one entry of
     W1); the reference tests' toy chain (2 steps) on Pasta, byte-equal to
     the reference's real-commitment proof where tests/data holds it, and
     on BN254/Grumpkin, each verified; the launch counts of those runs
     (msm_bucket, msm_merge, msm_wsum, mont_mul, to_affine and scale16
     must be > 0); one warm recursive prove under torch.profiler (the
     card's busy time and launches a step); then msm_bucket, msm_merge,
     msm_wsum and mont_mul against their plain versions on the inputs of
     the first commit and to_mont of each curve and shape, to_affine and
     scale16 on the first points of each key preparation, and the
     m = 65,536 and 32,768 commits timed beside their bound;
 11. the compressed recursive proof (RecursiveSNARK.compress /
     verify_compressed), with the launch counts set to 0 before it: the
     phase-10 SNARK set up for compression on both sides (the matrix
     tables by the h_tables kernel, each side timed), phase 10's BLAKE3
     proof compressed (each Spartan argument's parts and IPA rounds) and
     verified, the statement checked, both files' sizes, four tampers
     refused (z_final, sp1.vA, an IPA L point of sp_u1, u1.X[0]), the
     reference's toy proof compressed and verified (byte-equal to the
     port's committed compressed proof, tests/data) and a BN254/Grumpkin
     toy chain proved, compressed and verified; the launch counts of those
     runs (h_tables and every kernel of the path must be > 0); one warm
     Spartan argument (sp2) under torch.profiler (the card's busy time);
     then
     h_tables against its plain version on a seeded sixteenth of the rows
     of each BLAKE3 side's call (and the whole call's output on those
     rows), timed on the slice and whole beside its bound and its lane
     map's walk and join warp-steps (SM cycles a warp-step), and the kernel's
     tables of phase 9's chunk circuit against the host fold_point loop;
     the peak device memory;
 12. the per-step prover, checkpoints and the mesh, with the launch counts
     set to 0 before it: prove(fast=False) of phase 4's chunk (each step's
     host witness, device, commit and host ms), byte-equal to phase 4's
     proof and verified; prove_batch with checkpoint_every=8 (the save and
     load times), its last checkpoint resumed by a fresh IVC with the same
     bytes, one with a changed pp digest refused; a one-rank NCCL group
     (init_distributed from HOTPROOFS_COORDINATOR, _NUM_PROCESSES and
     _PROCESS_ID; the card machine has one H100) with a 1x1 mesh and a
     one-rank chain mesh: prove(mesh=) and prove_lockstep(mesh=) of phase
     4's chunks byte-equal to phase 4's proofs, msm_sharded at the comm_T
     shape equal to msm_many; then the launch counts of the phase
     (msm_bucket, msm_merge, msm_wsum and mont_mul must be > 0), those
     kernels against their plain versions on the phase's first commit and
     to_mont inputs, the phase's time and peak device memory;
 13. the batched Poseidon permutation (ops/poseidon.permute, the
     poseidon_permute kernel), which phases 4 and 8-12 must not have
     launched: with the launch counts set to 0, one permute of 131,072
     seeded states in each of eight specs (Pallas and Vesta scalar
     fields at the default (8, 57) and neptune (8, 55) rounds, BN254 and
     Grumpkin, the Pallas field at t = 5 and 9), one launch each; then
     each against its plain version (every state for the Pasta default
     specs, the first 4,096 for the others; exact equality) and 16
     states against host_permute, the kernel's time (CUDA-event mean of
     5 after one) beside its bound and the plain time, the latency of one
     state; four launches, each inside T.start_trace / T.stop_trace and
     a T.span("smoke/poseidon"), whose Chrome traces must name the span
     and the host's launch, whose timer must count each, and whose
     kernel record must be there or reported lost by stop_trace (this
     long-lived process can lose kernel records), then
     tools/trace_check.py in a process of its own, whose three captures
     must each name the kernel and the span and lose no record.
The last two lines are the kernels' JSON summary (with each kernel's
bound: the least time the card could take for the work of its timed
call) and the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

import numpy as np
import torch

FILE_BYTES = 64 << 20   # 65,536 chunks: a chunk proof is 16 blocks + 16 levels
# Phase 8's long chain: 1,024 steps on the depth-13 circuit, 8 segments in
# lockstep waves of 4.
LONG_STEPS, LONG_SEGMENTS, LONG_GROUP = 1024, 8, 4
# The reference's proof of chunk 1 of CHUNK2_DATA (tests/data).
REF_CHUNK2 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data", "torch_chunk2_proof_ref.json.gz")
CHUNK2_DATA = bytes(range(256)) * 4 + bytes(range(100))
CSRC = "hotproofs_tpu_torch/csrc/"
# kernel -> (source, TPU kernel it replaces)
KERNELS = {
    "msm_bucket": ("msm.cu", "hotproofs_tpu/ops/msm_pallas.py:210"),
    "msm_merge": ("msm.cu", "hotproofs_tpu/ops/msm_pallas.py:288"),
    "msm_wsum": ("msm.cu", "hotproofs_tpu/ops/msm_pallas.py:358"),
    "to_affine": ("msm.cu", "hotproofs_tpu/ops/msm_pallas.py:66"),
    "msm_chain": ("msm_designs.cu", "tools/exp_bucket2.py:30"),
    "msm_bucket_tsplit": ("msm_designs.cu", "tools/exp_tsplit.py:37"),
    "msm_bucket_signed": ("msm_designs.cu", "tools/exp_signed_msm.py:65"),
    "mont_mul": ("mont.cu", "hotproofs_tpu/ops/pallas_field.py:267"),
    "mont_mul_stage": ("mont.cu", "tools/bench_pallas_bisect.py:45"),
    "mont_mul_part": ("mont.cu", "tools/bench_pallas_parts.py:46"),
    "conv_mma": ("conv_mma.cu", "tools/bench_pallas_parts.py:74"),
    "scale16": ("points.cu", "hotproofs_tpu/ops/msm.py:62"),
    "h_tables": ("tables.cu", "hotproofs_tpu/nova/spartan.py:427"),
    "poseidon_permute": ("poseidon.cu", "hotproofs_tpu/ops/poseidon.py:247"),
}
MAIN = ("msm_bucket", "msm_merge", "msm_wsum", "to_affine",
        "mont_mul")                                            # phase 4
DESIGNS = ("msm_chain", "msm_bucket_tsplit", "msm_bucket_signed")  # phase 6
FIELD = ("mont_mul", "mont_mul_stage", "mont_mul_part", "conv_mma")  # phase 7
COMPRESS = ("msm_bucket", "msm_merge", "msm_wsum", "to_affine", "mont_mul",
            "scale16", "h_tables")                             # phase 9
# Phase 9's fixtures: the reference's IVC and compressed proofs of two toy
# chains (tests/data, made by the JAX package on the CPU), whose circuits
# and stack tests/spartan_chains.py holds.
TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
SPARTAN_CHAINS = ("toy", "wide")
RECURSIVE = ("msm_bucket", "msm_merge", "msm_wsum", "to_affine", "mont_mul",
             "scale16")                                        # phase 10
REC_COMPRESS = ("h_tables", "msm_bucket", "msm_merge", "msm_wsum",
                "to_affine", "mont_mul", "scale16")              # phase 11
# Phase 11's check of h_tables against its plain version: a seeded
# sixteenth of the rows of each call (rows are independent: one warp a
# row), with the longest rows.
TABLE_SLICE = 16
# Phase 10's kernel checks of the key preparations: the first points of
# each (to_affine's blocks and scale16's threads are independent, so a
# slice gives the kernel's values on those points).
AFFINE_CHECK, SCALE_CHECK = 1 << 16, 1 << 12
# Phase 9's check of scale16's affine windows against the host's ints: the
# first points of each call that are not the identity.
SCALE_HOST = 32
# Phase 13: seeded states a spec, and the states of each spec but the
# Pasta default ones held against the plain version.
POSEIDON_N, POSEIDON_CHECK = 1 << 17, 1 << 12

# The bound of a kernel's call: the larger of its bytes (each input read
# once, each output written once) over the HBM rate and its 32-bit integer
# multiplies over the card's multiply rate. A CIOS Montgomery product on
# 8 words takes 2 x (64 + 64) multiplies for its 32 x 32 -> 64 products
# (low and high halves) plus 8 for the reduction factors. An RCB15 mixed
# add needs 11 full products and a complete add 12 (csrc/curve.cuh does 2
# more, by the constant 3b = 15, which a few modular additions can do);
# to_affine needs 5 products a point (Montgomery's batch inversion, 3,
# then x and y) plus one Fermat inversion for the batch. A squaring needs
# only the 36 distinct word products of its operand (2 x 36 multiplies)
# beside the same reduction. On these curves (a = 0) the least doubling is
# the Jacobian one, 2 products and 5 squarings (dbl-2009-l), with no case
# for the identity; a point it leaves in Jacobian form reaches the
# homogeneous form to_affine reads with x Z and Z^3: 2 products here, the
# squaring of Z left out, which keeps the count at or under the least.
# The rate is the CUDA C++ Programming Guide's throughput of 32-bit integer
# multiply(-add) for compute capability 9.0, 64 per clock per SM, at the
# SM's maximum clock that nvidia-smi reports; the memory rate is the H100
# SXM's 3.35 TB/s.
MUL32_PER_MONT = 2 * (64 + 64) + 8
MUL32_PER_SQUARE = 2 * (36 + 64) + 8
MONT_MIXED_ADD, MONT_ADD = 11, 12
MONT_DOUBLE = 2 + 5 * MUL32_PER_SQUARE / MUL32_PER_MONT   # in products
MONT_TO_HOMOGENEOUS = 2     # a Jacobian point's x Z and Z^3 (Z^2 left out)
MONT_AFFINE = 5         # per point, beside one inversion per batch
IMUL_PER_CLOCK_SM = 64
HBM_BYTES_PER_S = 3.35e12


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    """Fail the run (exit code 1, no result line) unless cond."""
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _oracle_root(data: bytes) -> bytes:
    from hotproofs_tpu_torch.core import blake3_ref
    return blake3_ref.hash_bytes(data)


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn on the card over reps runs (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(monts: int, nbytes: int, rate: float):
    """(bound_ms, bound_by) of a call doing `monts` Montgomery products and
    moving `nbytes`, at `rate` 32-bit multiplies per second."""
    ops = monts * MUL32_PER_MONT / rate * 1e3
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def merge_bound(bk: torch.Tensor, red: torch.Tensor, rate: float):
    """(bound, bound_by, tree_bound) of msm_merge on buckets bk: one
    complete add fewer than the nonempty buckets (Z != 0) of each (job,
    slot), the least that sums them, beside the count that adds the
    kernel's trees over each slot's G threads in full (tree_bound, ms)."""
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    J, S, L = bk.shape[0], bk.shape[1], bk.shape[-1]
    live = (bk[:, :, 2] != 0).any(dim=2).sum(dim=2)         # (J, S)
    least = int((live - 1).clamp(min=0).sum())
    G = MP.merge_group(J, S, L)     # a slot's G sums take G - 1 adds
    trees = int(live.sum()) + J * S * (G - 1)
    ms, by = bound(MONT_ADD * least, nbytes(bk, red), rate)
    return ms, by, bound(MONT_ADD * trees, nbytes(bk, red), rate)[0]


def wsum_path(ms: float, S: int) -> str:
    """msm_wsum's critical path at S slots and its time per dependent
    complete add."""
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    d = MP.wsum_depth(S)
    return (f"msm_wsum {ms:.4f} ms over a critical path of {d} dependent "
            f"complete adds (the serial suffix sum: {2 * S}), "
            f"{ms / max(d, 1):.4f} ms an add")


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape, f"shapes {a.shape} != {b.shape}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def designs_phase(prover, data, dev, rng, note, stats, bounds,
                  rate) -> dict:
    """Phase 6 on prover's key (the blake3-nova key, bases prepared): the
    design kernels and the 8-slot merge and wsum against their plain
    versions, then the designs path at the shapes of tools/msm_designs.py
    (the W shapes on prover's W batch of chunks of data). Records the
    design kernels' times and bounds in stats and bounds; returns their
    launch counts during the designs path."""
    from hotproofs_tpu_torch.ops import curve as C
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.tools import msm_designs as D

    spec = C.PALLAS
    ck = prover.ivc.ck

    def design_check(inp, stats_out):
        """Each design kernel, and the 8-slot merge and wsum, == its plain
        version on inp. With stats_out, also time each (kernel: mean of 5
        after a warm-up; plain: one run), record the times of msm_chain at
        chain_split's H (and that H), the H = 2 t-split and the signed
        kernel there, and return all times by label."""
        sd = MP.msm_bucket_signed(spec, inp.sdigits, inp.sbases,
                                  inp.sbases_lm)
        red = MP.msm_merge(spec, sd)
        H = MP.chain_split(inp.J, inp.bases.shape[-1], inp.bases.shape[0])
        runs = {
            "msm_chain H=1": (
                lambda: MP.msm_chain(spec, inp.bases, inp.J, 1),
                lambda: MP.msm_chain_plain(spec, inp.bases, inp.J, 1)),
            f"msm_chain H={H}": (
                lambda: MP.msm_chain(spec, inp.bases, inp.J),
                lambda: MP.msm_chain_plain(spec, inp.bases, inp.J)),
            **{f"msm_bucket_tsplit H={h}": (
                lambda h=h: MP.msm_bucket_tsplit(spec, inp.digits,
                                                 inp.bases, h,
                                                 inp.bases_lm),
                lambda h=h: MP.msm_bucket_tsplit_plain(spec, inp.digits,
                                                       inp.bases, h))
               for h in D.TSPLITS},
            "msm_bucket_signed": (
                lambda: MP.msm_bucket_signed(spec, inp.sdigits, inp.sbases,
                                             inp.sbases_lm),
                lambda: MP.msm_bucket_signed_plain(spec, inp.sdigits,
                                                   inp.sbases)),
            "msm_merge S=8": (lambda: MP.msm_merge(spec, sd),
                              lambda: MP.msm_merge_plain(spec, sd)),
            "msm_wsum S=8": (lambda: MP.msm_wsum(spec, red),
                             lambda: MP.msm_wsum_plain(spec, red)),
        }
        times = {}
        for label, (kern, plain) in runs.items():
            got = kern()
            t0 = time.perf_counter()
            want = plain()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            note(label.split()[0], got, want)
            if stats_out is not None:
                times[label] = (cuda_ms(kern, 5), plain_ms)
        if stats_out is not None:
            for label in (f"msm_chain H={H}", "msm_bucket_tsplit H=2",
                          "msm_bucket_signed"):
                name = label.split()[0]
                stats_out[name]["ms"], stats_out[name]["plain_ms"] = \
                    times[label]
            stats_out["msm_chain"]["H"] = H
        return times

    m = 1000
    for bits in (40, 256):
        raw = rng.integers(0, 256, size=(3, m, 32), dtype=np.int64)
        raw[..., (bits + 7) // 8:] = 0
        raw[:, :, 31] &= 0x3F
        raw[1] = 0                                  # all-zero job
        if bits == 40:
            raw[0, 1, 4] |= 0xF0                    # top nibble 15
        sc = torch.from_numpy(raw.astype(np.int32)).to(dev)
        inp = D.prepare(ck, sc, bits)
        design_check(inp, None)
        B, _, _, L = inp.bases.shape
        say("6 designs", f"seeded {bits} bits (J=3, m={m}): msm_chain "
            f"(H=1, {MP.chain_split(3, L, B)}), msm_bucket_tsplit (H=2, "
            "4), msm_bucket_signed, merge and wsum (S=8) == plain")
    J, m, bits = D.SHAPES["comm_T J=1"]
    inp = D.prepare(ck, D.random_scalars(rng, J, m, bits, dev), bits)
    times = design_check(inp, stats)
    live = int((inp.digits != 0).sum())
    slive = int(((inp.sdigits & 15) != 0).sum())
    B, L = inp.digits.shape[1:]
    SL = inp.sdigits.shape[-1]
    pt = 3 * 8 * 4                                  # bytes of a point
    signed_out = J * MP.NSIGNED * pt * SL
    chain_bound = bound(MONT_MIXED_ADD * J * B * L,
                        nbytes(inp.bases) + J * pt * L, rate)
    label_bounds = {
        **{label: chain_bound for label in times
           if label.startswith("msm_chain")},
        **{f"msm_bucket_tsplit H={h}": bound(
            MONT_MIXED_ADD * live, nbytes(inp.digits, inp.bases)
            + J * MP.NBUCKET * pt * h * L, rate) for h in D.TSPLITS},
        "msm_bucket_signed": bound(MONT_MIXED_ADD * slive,
                                   nbytes(inp.sdigits, inp.sbases)
                                   + signed_out, rate),
        "msm_merge S=8": merge_bound(
            MP.msm_bucket_signed(spec, inp.sdigits, inp.sbases,
                                 inp.sbases_lm),
            torch.empty(J, MP.NSIGNED, 3, 8, dtype=torch.int32), rate)[:2],
        "msm_wsum S=8": bound(MONT_ADD * J * 2 * MP.NSIGNED,
                              J * MP.NSIGNED * pt + J * pt, rate),
    }
    say("6 times", "comm_T J=1: " + ", ".join(
        f"{k} {v[0]:.3f} ms (plain {v[1]:.1f} ms, bound "
        f"{label_bounds[k][0]:.4f} ms by {label_bounds[k][1]})"
        for k, v in times.items()))
    bounds["msm_chain"] = chain_bound
    for label in ("msm_bucket_tsplit H=2", "msm_bucket_signed"):
        bounds[label.split()[0]] = label_bounds[label]
    del inp
    torch.cuda.empty_cache()

    MP.reset_launches()
    res = D.run(prover, data, rng, out=lambda line: say("6 designs", line))
    torch.cuda.synchronize()
    design_counts = dict(MP.launches)
    require(D.all_ok(res), "a design's MSM, or msm_many's at another B, "
            "disagrees with msm_many (or msm_chain with its plain version)")
    say("6 times", "W J=256: " + wsum_path(res["W J=256"]["msm_wsum"],
                                           MP.NBUCKET))
    say("6 launches", ", ".join(f"{k} {design_counts[k]}" for k in DESIGNS))
    for k in DESIGNS:
        require(design_counts[k] > 0, f"{k} was not launched on the "
                "designs path")
    say("6 host", ", ".join(f"{k} {v:.3f}" for k, v in res["host"].items()))
    return {k: design_counts[k] for k in DESIGNS}


@contextlib.contextmanager
def capturing(seen: dict, label: str):
    """While active, keep in seen the inputs of the first msm_many and
    to_mont call of each curve or field and shape not seen before whose
    scalars are not all zero (a chain's first cross term is), keyed by
    (kind, curve or field, shape), with the label of the run that gave
    them: phases 8 and 10 hold the kernels against their plain versions on
    them."""
    from hotproofs_tpu_torch.ops import field as F
    from hotproofs_tpu_torch.ops import msm_pallas as MP

    msm_many, to_mont = MP.msm_many, F.to_mont

    def msm_rec(spec, scalars, bases, m, max_bits, b=None, bases_lm=None):
        key = ("msm", spec.name, (scalars.shape[0], m, max_bits))
        if key not in seen and bool(scalars.any()):
            seen[key] = (label, spec, scalars.clone(), bases, m, max_bits,
                         b, bases_lm)
        return msm_many(spec, scalars, bases, m, max_bits, b, bases_lm)

    def mont_rec(spec, a):
        key = ("to_mont", spec.name, tuple(a.shape))
        if key not in seen and bool(a.any()):
            seen[key] = (label, spec, a.clone())
        return to_mont(spec, a)

    MP.msm_many, F.to_mont = msm_rec, mont_rec
    try:
        yield
    finally:
        MP.msm_many, F.to_mont = msm_many, to_mont


def check_captured(seen: dict, dev, note, tag: str) -> None:
    """msm_bucket, msm_merge and msm_wsum (each captured MSM) and mont_mul
    (each captured to_mont) == their plain versions on the inputs."""
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.ops import pallas_field as PF

    for (kind, where, dims), (label, *inp) in seen.items():
        t0 = time.perf_counter()
        if kind not in ("msm", "to_mont"):
            continue
        if kind == "to_mont":
            spec, x = inp
            note("mont_mul", PF.mont_mul_em(spec, x, PF.const_digits(
                spec, "r2", dev)), PF.mont_mul_em_plain(
                spec, x, PF.const_digits(spec, "r2", dev)))
            what = f"mont_mul (to_mont of {' x '.join(map(str, dims[:2]))}" \
                f", {where})"
        else:
            spec, sc, bases, m, bits, b, lm = inp
            b, lpw, w4, _ = MP.plan(m, bits, b)
            d = MP.digits_tm(sc, m, b, lpw, w4)
            bk = MP.msm_bucket(spec, d, bases, lm)
            note("msm_bucket", bk, MP.msm_bucket_plain(spec, d, bases))
            red = MP.msm_merge(spec, bk)
            note("msm_merge", red, MP.msm_merge_plain(spec, bk))
            note("msm_wsum", MP.msm_wsum(spec, red),
                 MP.msm_wsum_plain(spec, red))
            what = f"msm_bucket, msm_merge, msm_wsum ({where}, " \
                f"J={dims[0]}, m={m}, {bits} bits, nonzero digits " \
                f"{float((d != 0).float().mean()):.4f})"
        torch.cuda.synchronize()
        say(tag, f"{label}: {what} == plain "
            f"({time.perf_counter() - t0:.1f} s)")


def segments_phase(prover, data, ci, proof, root, dev, note) -> dict:
    """Phase 8: the verification key and the segments path. Returns the
    kernels' launch counts of the phase (its kernel checks, which come
    last, not counted)."""
    import tempfile

    from hotproofs_tpu_torch.models.chunk_prover import verify_with_vk
    from hotproofs_tpu_torch.nova.vk import ivc_from_vk
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.parallel.segments import SegmentedProof
    from hotproofs_tpu_torch.tools import longchain_deep as LD
    from hotproofs_tpu_torch.utils import telemetry as T_

    tag = "8 vk+segments"
    seen: dict = {}
    MP.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        vk = os.path.join(tmp, "vk.json")
        prover.export_vk(vk)
        t0 = time.perf_counter()
        got = verify_with_vk(vk, proof, device=dev)
        say(tag, f"verify_with_vk chunk {ci} ({proof.ivc_proof.num_steps} "
            f"folds) from the vk alone: {time.perf_counter() - t0:.2f} s "
            f"(vk {os.path.getsize(vk)} bytes)")
        require(got == root, "verify_with_vk returned another root")
        with open(vk) as f:
            d = json.load(f)
        d["A"]["vals"][0] = (d["A"]["vals"][0] + 1) % prover.modulus
        bad = os.path.join(tmp, "bad_vk.json")
        with open(bad, "w") as f:
            json.dump(d, f)
        try:
            ivc_from_vk(bad, device=dev)
        except AssertionError as e:
            require("pp digest mismatch" in str(e), f"vk refused: {e}")
            say(tag, f"vk with one matrix value changed refused ({e})")
        else:
            require(False, "a vk with a changed matrix value was accepted")

        t0 = time.perf_counter()
        with capturing(seen, "chunk, lockstep K=4"):
            root_s, sp = prover.prove_segmented(data, ci, 4)
        dt = time.perf_counter() - t0
        n = sp.segmented.num_steps
        say(tag, f"prove_segmented chunk {ci}: {n} folds as segments of "
            f"{[s.num_steps for s in sp.segmented.segments]} in lockstep in "
            f"{dt:.2f} s ({n / dt:.3f} folds/s)")
        t0 = time.perf_counter()
        with capturing(seen, "chunk, thread pool"):
            _, pool = prover.prove_segmented(data, ci, 4, devices=[dev])
        dt = time.perf_counter() - t0
        require(json.dumps(pool.to_dict()) == json.dumps(sp.to_dict()),
                "the thread pool's segments differ from the lockstep's")
        say(tag, f"prove_segmented chunk {ci} on the thread pool "
            f"(devices=[{dev}]): {dt:.2f} s ({n / dt:.3f} folds/s), "
            "byte-equal to the lockstep proof")
        t0 = time.perf_counter()
        require(root_s == root and prover.verify_segmented(sp) == root,
                "verify_segmented returned another root")
        say(tag, f"verify_segmented: {time.perf_counter() - t0:.2f} s")
        zs, _, canon, X = prover._device_witness_chain(
            prover._hash_with_path(data, ci))
        alone = prover.ivc.prove_batch(zs[16], canon[16:24], X[16:24])
        require(json.dumps(alone.to_dict()) == json.dumps(
            sp.segmented.segments[2].to_dict()),
            "segment 2 differs from its standalone prove_batch")
        say(tag, "segment 2 is byte-equal to prove_batch over steps "
            "[16, 24)")
        swapped = SegmentedProof.from_dict(sp.segmented.to_dict())
        s = swapped.segments
        s[1], s[2] = s[2], s[1]
        try:
            prover.verify_segmented(type(sp)(swapped, sp.chunk_idx,
                                             sp.n_blocks, sp.leaf_depth,
                                             sp.total_depth))
        except AssertionError as e:
            require("does not chain" in str(e), f"swap refused: {e}")
            say(tag, f"segments 1 and 2 swapped: refused ({e})")
        else:
            require(False, "a segmented proof with swapped segments "
                    "verified")

        # The reference's real-size proof (JAX package, on the CPU) of
        # chunk 1 of a 2-chunk file: the port accepts it and proves the
        # same bytes on the card.
        ref = gzip.decompress(open(REF_CHUNK2, "rb").read())
        ref_path = os.path.join(tmp, "ref.json")
        with open(ref_path, "wb") as f:
            f.write(ref)
        want = _oracle_root(CHUNK2_DATA)
        require(prover.verify(type(proof).load(ref_path), want) == want,
                "the reference's chunk proof did not verify")
        got, mine = prover.prove(CHUNK2_DATA, 1)
        mine_path = os.path.join(tmp, "port.json")
        mine.save(mine_path)
        with open(mine_path, "rb") as f:
            require(got == want and f.read() == ref,
                    "the port's proof differs from the reference's")
        say(tag, "the reference's proof of a 2-block chunk verifies, and "
            "the port's proof of it is byte-equal")

        t0 = time.perf_counter()
        p13 = type(prover)(depth_bits=LD.DEPTH_BITS, device=dev)
        p13.ivc.prepare_key()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        chain = LD.deep_chain(p13, LONG_STEPS)
        say(tag, f"depth-{LD.DEPTH_BITS} prover setup {setup:.1f} s; "
            f"{LONG_STEPS}-step witness on the card, kept on the host "
            f"({chain['canon'].nbytes / 1e9:.2f} GB): "
            f"{chain['witness_s']:.1f} s")
        ckpt = os.path.join(tmp, "ckpt")
        with capturing(seen, f"depth {LD.DEPTH_BITS}, lockstep K="
                       f"{LONG_GROUP}"):
            first = LD.prove(p13, chain, LONG_SEGMENTS, LONG_GROUP, ckpt,
                             stop_after=1)
        require(first["proof"] is None and first["proved"] == LONG_GROUP,
                f"the first run proved {first['proved']} segments, want "
                f"{LONG_GROUP} (one wave)")
        second = LD.prove(p13, chain, LONG_SEGMENTS, LONG_GROUP, ckpt)
        want = LONG_SEGMENTS - LONG_GROUP
        require(second["resumed"] == LONG_GROUP and second["proved"] == want,
                f"the rerun resumed {second['resumed']} and proved "
                f"{second['proved']} segments, want {LONG_GROUP} and {want}")
        for i, w in enumerate(first["waves"] + second["waves"]):
            say(tag, f"wave {i + 1}: {w['segments']} segments, {w['folds']} "
                f"folds in {w['s']:.2f} s ({w['folds_per_s']:.3f} folds/s)")
        say(tag, f"rerun: {second['resumed']} resumed, {second['proved']} "
            "proved")
        v = LD.verify(p13, chain, second["proof"])
        say(tag, f"verify_segments of the {LONG_STEPS}-step chain: {v:.2f} s;"
            f" final state == the published root "
            f"{chain['pd'].root_hash.hex()[:16]}...")
    torch.cuda.synchronize()
    counts = dict(MP.launches)
    say(tag, f"phase {time.perf_counter() - t_phase:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        "launches " + ", ".join(f"{k} {counts[k]}" for k in MAIN))
    for k in ("msm_bucket", "msm_merge", "msm_wsum", "mont_mul"):
        require(counts[k] > 0, f"{k} was not launched in phase 8")
    # The span timers of the two segment paths (process totals: phase 8
    # is the first to prove segments).
    timers = T_.metrics.snapshot()["timers"]
    for k in ("segments/lockstep_wave", "segments/prove_one"):
        require(k in timers, f"no {k} span was timed")
        say(tag, f"span timer {k}: {timers[k]}")
    require(timers["segments/prove_one"]["calls"] >= 4,
            "the thread pool's 4 segments were not timed")
    check_captured(seen, dev, note, tag)
    return counts


@contextlib.contextmanager
def capturing_compress(seen: dict, ck):
    """While active, keep in seen the inputs of the first scale16 call of
    each point count, and in seen["ipa"] the scalars of every J = 2 commit
    over ck, in order (the IPA rounds)."""
    from hotproofs_tpu_torch.ops import msm_pallas as MP

    scale, commit_many = MP.scale16, ck.commit_many

    def scale_rec(spec, pts, windows):
        seen.setdefault(("scale16", pts.shape[0]),
                        (spec, pts.clone(), windows))
        return scale(spec, pts, windows)

    def commit_rec(scalars, max_bits=256):
        if scalars.shape[0] == 2:
            seen.setdefault("ipa", []).append(scalars.clone())
        return commit_many(scalars, max_bits)

    MP.scale16, ck.commit_many = scale_rec, commit_rec
    try:
        yield
    finally:
        MP.scale16 = scale
        del ck.commit_many          # the class's method again


def ipa_rounds(spec, ck, rounds, tag, smi, rate) -> None:
    """One IPA's rounds timed on the card, replayed on the scalars its
    compress gave them: each round's J = 2 commit over the key's prepared
    bases (CUDA events, mean of 3 after one) and its two mont_mul at the
    round's shape (mean of 5). The commit's bound counts a mixed add for
    each nonzero digit only, as comm_T's does."""
    from hotproofs_tpu_torch.ops import field as F
    from hotproofs_tpu_torch.ops import msm_pallas as MP

    fs = spec.scalar
    total = bound_sum = 0.0
    for k, sc in enumerate(rounds):
        m = sc.shape[1]
        b, lpw, w4, _ = MP.plan(m, 256)
        live = int((MP.digits_tm(sc, m, b, lpw, w4) != 0).sum())
        nonzero = int(sc.any(-1).sum())
        bnd = bound(MONT_MIXED_ADD * live,
                    nbytes(sc, ck.bases_lm(m, 256)) + 2 * 3 * 8 * 4, rate)
        ck.commit_many(sc, 256)
        msm = cuda_ms(lambda: ck.commit_many(sc, 256), 3)
        mul = cuda_ms(lambda: F.mont_mul(fs, sc[0], sc[1]), 5)
        total += msm + 2 * mul
        bound_sum += bnd[0]
        say(tag, f"IPA round {k + 1} (n_k = {m >> k}): J = 2 commit over the "
            f"key's {m} prepared bases {msm:.3f} ms (bound {bnd[0]:.4f} ms "
            f"by {bnd[1]}: {live} of {2 * m * w4} digits nonzero, "
            f"{nonzero} of {2 * m} scalars), 2 mont_mul of {m} "
            f"{2 * mul:.4f} ms [{smi}]")
    say(tag, f"one IPA's {len(rounds)} rounds: {total:.2f} ms of commits "
        f"and mont_mul (x 3 IPAs: {3 * total:.1f} ms); the commits' bounds "
        f"sum to {bound_sum:.3f} ms [{smi}]")


def compression_phase(prover, data, ci, proof, root, dev, note, stats,
                      bounds, rate, smi) -> dict:
    """Phase 9: Spartan compression. Setup on the phase-4 prover (the H
    tables built or loaded, then laid out on the card), compress and
    verify_compressed of phase 4's proof, four tampers refused, the
    cache's checks, the CLI's prove --compress and verify, the reference's
    fixtures (toy and wide: accepted, byte-equal) and its real-size chunk
    proof compressed and verified; then scale16 against its plain version
    on the inputs setup gave it, timed, with its bound, and the first IPA's
    rounds timed (ipa_rounds). Requires that compress and verify after
    setup launch no scale16 and no to_affine, and msm_bucket once per IPA
    round and once for the commitment to L. Returns the launch counts of
    setup, compress and verify (the phase's main path)."""
    import copy
    import tempfile

    from hotproofs_tpu_torch.models import chunk_prover as CP
    from hotproofs_tpu_torch.nova import spartan as SP
    from hotproofs_tpu_torch.nova.ivc import IVCProof
    from hotproofs_tpu_torch.ops import curve as C
    from hotproofs_tpu_torch.ops import field as F
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.utils import telemetry as T_
    from hotproofs_tpu_torch.utils.config import CONFIG

    if TESTS_DIR not in sys.path:
        sys.path.append(TESTS_DIR)
    from spartan_chains import load_ref, port_stack

    tag = "9 compress"
    counter = lambda k: T_.metrics.snapshot()["counters"].get(k, 0)
    spec = prover.ivc.curve
    ck = prover.ivc.ck
    seen: dict = {}
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # Setup: the tables of the blake3 circuit by h_tables (a table file an
    # earlier run cached is removed first), then on the card with the key's
    # bases at the IPAs' lengths.
    for name in os.listdir(CONFIG.cache_dir):
        if name.startswith("torch_spartanH_"):
            os.remove(os.path.join(CONFIG.cache_dir, name))
    MP.reset_launches()
    builds = counter("spartan/h_builds")
    t0 = time.perf_counter()
    sps = prover.spartan
    sps.preprocess_H()
    t_h = time.perf_counter() - t0
    t0 = time.perf_counter()
    with capturing_compress(seen, ck):
        sps.setup()
    torch.cuda.synchronize()
    t_lay = time.perf_counter() - t0
    set_up = dict(MP.launches)
    how = "built by h_tables" if counter("spartan/h_builds") > builds \
        else "loaded from the cache"
    nnz = sum(len(x.rows) for x in (sps.shape.A, sps.shape.B, sps.shape.C))
    say(tag, f"SpartanSystem (m = {sps.m}, nz = {sps.nz}, n_ipa_w = "
        f"{sps.n_ipa_w}): H tables {how} in {t_h:.2f} s (nnz {nnz}); setup "
        f"(the tables' {3 * sps.m} points and the key's bases at the IPAs' "
        f"lengths on the card) in {t_lay:.2f} s, scale16 "
        f"{set_up['scale16']}, to_affine {set_up['to_affine']} [{smi}]")
    loads = counter("spartan/h_loads")
    t0 = time.perf_counter()
    again = SP.SpartanSystem(prover.ivc)
    xs = again.preprocess_H()
    require(counter("spartan/h_loads") == loads + 1 and all(
        np.array_equal(a, b) for a, b in zip(xs, sps.preprocess_H())),
        "a second SpartanSystem did not load the same tables from the cache")
    say(tag, f"a second SpartanSystem loaded them from the cache in "
        f"{time.perf_counter() - t0:.2f} s [{smi}]")

    # The main path: compress the 32-fold proof of phase 4, verify it.
    rounds = counter("spartan/ipa_rounds")
    t0 = time.perf_counter()
    with capturing_compress(seen, ck):
        cproof = prover.compress(proof)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    n_rounds = counter("spartan/ipa_rounds") - rounds
    buckets = MP.launches["msm_bucket"] - set_up["msm_bucket"]
    say(tag, f"compress chunk {ci} ({cproof.compressed.num_steps} folds): "
        f"{t_c:.2f} s [{smi}]; " + ", ".join(
            f"{k} {v:.3f} s" for k, v in sps.timings.items())
        + f"; {n_rounds} IPA rounds, each a host round trip (L, R read "
        "back, absorbed, a challenge drawn)")
    t0 = time.perf_counter()
    require(prover.verify_compressed(cproof) == root,
            "verify_compressed returned another root")
    t_v = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(MP.launches)
    say(tag, f"verify_compressed: {t_v:.2f} s [{smi}]")
    say(tag, "launches (setup, compress, verify): " + ", ".join(
        f"{k} {counts[k]}" for k in COMPRESS))
    for k in COMPRESS:
        require(counts[k] > 0, f"{k} was not launched in compression")
    for k in ("scale16", "to_affine", "h_tables"):
        require(counts[k] == set_up[k], f"compress and verify after setup "
                f"launched {k} {counts[k] - set_up[k]} times: the IPA must "
                "commit over the key's prepared bases")
    require(buckets == n_rounds + 1 and len(seen["ipa"]) == n_rounds,
            f"compress launched msm_bucket {buckets} times and made "
            f"{len(seen['ipa'])} J = 2 commits for {n_rounds} IPA rounds "
            "and the commitment to L")
    say(tag, f"after setup: compress launched msm_bucket {buckets} times "
        f"({n_rounds} IPA rounds, each one J = 2 commit over the key's "
        "prepared bases, and the commitment to L); compress and verify "
        "launched no scale16, to_affine or h_tables")

    with tempfile.TemporaryDirectory() as tmp:
        full, small = os.path.join(tmp, "p.json"), os.path.join(tmp, "c.json")
        proof.save(full)
        cproof.save(small)
        say(tag, f"proof files: uncompressed {os.path.getsize(full)} bytes, "
            f"compressed {os.path.getsize(small)} bytes")
        back = CP.CompressedChunkProof.load(small)
        require(prover.verify_compressed(back) == root,
                "the saved compressed proof did not verify")

        def refused(what, change, want):
            bad = copy.deepcopy(cproof)
            change(bad.compressed.spartan)
            try:
                prover.verify_compressed(bad)
            except AssertionError as e:
                require(want in str(e), f"{what}: refused as {e}")
                say(tag, f"{what}: refused ({e})")
            else:
                require(False, f"a compressed proof with {what} verified")

        p = sps.fspec.p

        def bump_ev(sp):
            sp.sc1_evals[3][1] = (sp.sc1_evals[3][1] + 1) % p

        def bump_L(sp):
            sp.ipa_W.Ls[5] = sp.ipa_W.Rs[5]

        refused("vL changed",
                lambda sp: setattr(sp, "vL", (sp.vL + 1) % p),
                "IPA opening of L failed")
        refused("one sum-check evaluation changed", bump_ev,
                "sum-check 1 failed")
        refused("one IPA L point changed", bump_L, "IPA opening of W failed")
        refused("a sum-check round dropped",
                lambda sp: setattr(sp, "sc2_evals", sp.sc2_evals[:-1]),
                "sum-check 2 round count")

        # The cache refuses a file whose stored digest was changed, and the
        # table is rebuilt (on the toy circuit: a full rebuild is the H
        # build's time again).
        toy_ivc, toy, _ = port_stack("toy", device=dev)
        toy.preprocess_H()
        path = SP._h_cache_path(toy.curve, toy.m, toy.pp_digest)
        with np.load(path) as z:
            arrs = {k: z[k] for k in z.files}
        meta = json.loads(str(arrs["meta"]))
        meta["pp_digest"] = f"{toy.pp_digest ^ 1:064x}"
        arrs["meta"] = np.asarray(json.dumps(meta))
        np.savez(path, **arrs)
        refusals = counter("spartan/h_refused")
        fresh = SP.SpartanSystem(toy_ivc).preprocess_H()
        require(counter("spartan/h_refused") == refusals + 1 and all(
            np.array_equal(a, b) for a, b in zip(fresh, toy.preprocess_H())),
            "a cached table with a changed digest was not refused and "
            "rebuilt")
        say(tag, f"a cached table whose stored digest was changed "
            f"({os.path.relpath(path, CONFIG.cache_dir)}): refused, rebuilt")

        # The CLI: prove --compress on a small file, then verify.
        f_in = os.path.join(tmp, "small.bin")
        small_data = data[:4096]
        with open(f_in, "wb") as f:
            f.write(small_data)
        out = os.path.join(tmp, "cli.json")
        t0 = time.perf_counter()
        CP.main(["prove", "--file", f_in, "--chunk", "1", "--out", out,
                 "--compress"])
        CP.main(["verify", "--proof", out, "--expect-hash",
                 _oracle_root(small_data).hex()])
        with open(out) as f:
            require(json.load(f)["kind"] == "compressed_chunk_proof",
                    "prove --compress did not write a compressed proof")
        say(tag, f"CLI prove --compress (chunk 1 of a 4 KiB file) and "
            f"verify: {time.perf_counter() - t0:.2f} s [{smi}]")

        # The reference's fixtures on the card: its compressed proof is
        # accepted and the port's compression of its IVC proof equals it.
        for name in SPARTAN_CHAINS:
            d = load_ref(name)
            sp_sys = toy if name == "toy" else \
                port_stack(name, device=dev)[1]
            want = [d["z_final"]]
            require(sp_sys.verify(SP.CompressedProof.from_dict(
                d["compressed_proof"]), 1) == want,
                f"the reference's {name} compressed proof did not verify")
            mine = sp_sys.compress(IVCProof.from_dict(d["ivc_proof"]), 1)
            mp_ = os.path.join(tmp, f"{name}.json")
            mine.save(mp_)
            with open(mp_) as f:
                require(f.read() == json.dumps(d["compressed_proof"]),
                        f"the port's {name} compressed proof differs from "
                        "the reference's")
            say(tag, f"{name} fixture (m = {sp_sys.m}, "
                f"{len(d['compressed_proof']['spartan']['ipa_L']['Ls'])} "
                "IPA rounds a proof): the reference's compressed proof "
                "verifies; the port's is byte-equal")

        # The reference's real-size proof of chunk 1 of a 2-chunk file
        # (phase 8), compressed and verified.
        ref_path = os.path.join(tmp, "ref.json")
        with open(ref_path, "wb") as f:
            f.write(gzip.decompress(open(REF_CHUNK2, "rb").read()))
        want = _oracle_root(CHUNK2_DATA)
        t0 = time.perf_counter()
        rc = prover.compress(CP.ChunkProof.load(ref_path))
        require(prover.verify_compressed(rc, want) == want,
                "the reference's chunk proof, compressed, did not verify")
        say(tag, f"the reference's real-size chunk proof: compressed and "
            f"verified in {time.perf_counter() - t0:.2f} s [{smi}]")

    # scale16 against its plain version on what setup gave it: the tables'
    # points, and the key's generators where setup prepared them.
    def affine(w):
        x, y = MP.to_affine_words_plain(
            spec, *(w[:, c].contiguous() for c in range(3)))
        return torch.stack([x, y])

    n_tab = 3 * sps.m
    require(("scale16", n_tab) in seen,
            "setup made no scale16 call on the tables' points")
    runs = [n for n in (ck.n, n_tab) if ("scale16", n) in seen]
    for n in runs:
        sspec, pts, windows = seen[("scale16", n)]
        what = "the key's generators" if n == ck.n else "the tables' points"
        got = MP.scale16(sspec, pts, windows)
        t0 = time.perf_counter()
        want = MP.scale16_plain(sspec, pts, windows)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        note("scale16", got, want)
        cut = min(got.shape[0] * n, 1 << 16)     # plain inversions: a slice
        note("scale16", affine(got.reshape(-1, 3, 8)[:cut]),
             affine(want.reshape(-1, 3, 8)[:cut]))
        # The first SCALE_HOST points that are not the identity, at every
        # window, against 16^w P on the host's ints (scaled_affine_host).
        idx = [i for i in range(min(n, 8 * SCALE_HOST))
               if bool(pts[i, 2].any())][:SCALE_HOST]
        require(len(idx) == SCALE_HOST, f"scale16: under {SCALE_HOST} "
                f"points not the identity among the first of {what}")
        host_pts = C.pt_to_affine_host(sspec, MP.words_point(pts[idx]))
        hx, hy = MP.scaled_affine_host(sspec, host_pts, windows)
        kx, ky = affine(got[:, idx].reshape(-1, 3, 8))
        require(np.array_equal(F.words_to_digits(kx).cpu().numpy(),
                               hx.reshape(-1, 32))
                and np.array_equal(F.words_to_digits(ky).cpu().numpy(),
                                   hy.reshape(-1, 32)),
                f"scale16: affine windows != 16^w P on the host ({what})")
        ms = cuda_ms(lambda: MP.scale16(sspec, pts, windows), 5)
        # The identity (Z = 0) needs no work: only the other points count.
        live = int((pts[:, 2] != 0).any(-1).sum())
        steps = windows - 1
        bnd = bound(live * steps * (4 * MONT_DOUBLE + MONT_TO_HOMOGENEOUS),
                    nbytes(pts, got), rate)
        say(tag, f"scale16 == plain (projective and affine) on {what}, "
            f"affine == the host's 16^w P at {SCALE_HOST} points x "
            f"{windows} windows, "
            f"{n} points ({live} not the identity) at W4 = {windows}: "
            f"{ms:.3f} ms (plain {plain_ms:.1f} ms, bound {bnd[0]:.4f} ms "
            f"by {bnd[1]}: {4 * steps} Jacobian doublings and {steps} "
            f"conversions a point) [{smi}]")
        if n == n_tab:
            stats["scale16"]["ms"], stats["scale16"]["plain_ms"] = \
                ms, plain_ms
            bounds["scale16"] = bnd
        del got, want

    ipa_rounds(spec, ck, seen["ipa"][:sps.nz.bit_length() - 1], tag, smi,
               rate)
    say(tag, f"phase {time.perf_counter() - t_phase:.1f} s [{smi}]; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"scale16": counts["scale16"]}


@contextlib.contextmanager
def capturing_keys(seen: dict, label: str):
    """While active, keep in seen the first points of each key
    preparation's scale16 and to_affine call, keyed by (kind, curve, point
    count), with the label of the run that gave them."""
    from hotproofs_tpu_torch.ops import msm_pallas as MP

    scale, aff = MP.scale16, MP.to_affine_words

    def scale_rec(spec, pts, windows):
        seen.setdefault(("scale16", spec.name, pts.shape[0]), (
            label, spec, pts[:SCALE_CHECK].clone(), windows))
        return scale(spec, pts, windows)

    def aff_rec(spec, X, Y, Z):
        seen.setdefault(("to_affine", spec.name, X.shape[0]), (
            label, spec) + tuple(c[:AFFINE_CHECK].clone() for c in (X, Y, Z)))
        return aff(spec, X, Y, Z)

    MP.scale16, MP.to_affine_words = scale_rec, aff_rec
    try:
        yield
    finally:
        MP.scale16, MP.to_affine_words = scale, aff


def commit_times(seen: dict, rate: float, tag: str, smi: str) -> None:
    """The 256-bit commits of phase 10 timed on their captured scalars
    (CUDA events, mean of 5 after one), beside the MSM's bound: a mixed add
    for each nonzero digit, the scalars and the lane-major bases read once,
    one projective point written."""
    from hotproofs_tpu_torch.ops import msm_pallas as MP

    for (kind, where, dims), (label, *inp) in seen.items():
        if kind != "msm":
            continue
        spec, sc, bases, m, bits, b, lm = inp
        b, lpw, w4, _ = MP.plan(m, bits, b)
        live = int((MP.digits_tm(sc, m, b, lpw, w4) != 0).sum())
        run = lambda: MP.msm_many(spec, sc, bases, m, bits, b, lm)
        run()
        ms = cuda_ms(run, 5)
        bnd = bound(MONT_MIXED_ADD * live, nbytes(sc, lm) + 3 * 8 * 4, rate)
        say(tag, f"{label}: commit on {where} (J={dims[0]}, m={m}, {bits} "
            f"bits): msm_many {ms:.3f} ms, bound {bnd[0]:.4f} ms by {bnd[1]} "
            f"({live} of {dims[0] * m * w4} digits nonzero; "
            f"{100 * bnd[0] / ms:.1f} % of the bound) [{smi}]")


def recursive_phase(prover, data, ci, root, dev, note, rate, smi) -> dict:
    """Phase 10: the recursive SNARK. The full-width BLAKE3 chain of phase
    4's chunk (prove, verify, four tampers), the toy chains on Pasta (byte
    parity with the reference's fixture where tests/data holds it) and
    BN254/Grumpkin, their launch counts, one warm prove profiled, then the
    kernels held against their plain versions on the phase's inputs and
    the new commit widths timed. Returns the launch counts of the
    chains and the BLAKE3 chain's proof."""
    import copy
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hotproofs_tpu_torch.models import chunk_prover as CP
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.utils.config import CONFIG

    if TESTS_DIR not in sys.path:
        sys.path.append(TESTS_DIR)
    import test_torch_recursive_fixtures as RC

    tag = "10 recursive"
    seen: dict = {}
    # Bases an earlier run cached on disk would skip the key preparation.
    for name in os.listdir(CONFIG.cache_dir):
        if name.startswith("torch_scaledaff_") and (
                "_blake3-rec-" in name or "_test-recursive" in name):
            os.remove(os.path.join(CONFIG.cache_dir, name))
    MP.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    with capturing(seen, "blake3-rec"), capturing_keys(seen, "blake3-rec"):
        t0 = time.perf_counter()
        rs = prover.recursive
        say(tag, f"RecursiveSNARK over the BLAKE3 step in "
            f"{time.perf_counter() - t0:.1f} s (probe circuits "
            f"{rs.setup_times['probes']:.1f} s, vk over both probe shapes "
            f"{rs.setup_times['vk']:.2f} s, both sides' circuits and shapes "
            f"{rs.setup_times['sides']:.1f} s) [{smi}]")
        for side in (rs.side1, rs.side2):
            sh = side.shape
            nnz = [len(getattr(sh, x).rows) for x in "ABC"]
            t0 = time.perf_counter()
            ck = side.ck
            t_der = time.perf_counter() - t0
            t0 = time.perf_counter()
            ck.bases_lm(side.n_pad, 256)
            torch.cuda.synchronize()
            say(tag, f"{side.name} on {side.curve.name}: {sh.n_cons} "
                f"constraints, {sh.n_vars} signals, nnz A/B/C {nnz}, "
                f"commit width {side.n_pad}; key: {side.n_pad} generators "
                f"in {t_der:.1f} s, prepared (64 windows) in "
                f"{time.perf_counter() - t0:.2f} s [{smi}]")
        say(tag, f"device memory after both keys: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        t0 = time.perf_counter()
        root_r, rp = prover.prove_recursive(data, ci)
        t_prove = time.perf_counter() - t0
        require(root_r == root, "prove_recursive returned another root")
        n = rp.rec.n_steps
        steps = rs.timings
        parts = ("synth_primary", "synth_secondary", "device", "commit")
        for st in steps:    # the host's other work: step function, RO, folds
            st["other"] = st["wall"] - sum(st[p] for p in parts)
        for k, st in enumerate(steps, 1):
            say(tag, f"step {k}/{n}: synthesis primary "
                f"{st['synth_primary']:.1f} ms, secondary "
                f"{st['synth_secondary']:.1f} ms; device (to_mont, SpMV, "
                f"cross terms, folds) {st['device']:.1f} ms; commits "
                f"{st['commit']:.1f} ms; other host work {st['other']:.1f} "
                f"ms; wall {st['wall']:.1f} ms")
        warm = steps[1:] or steps
        mean = lambda k: sum(st[k] for st in warm) / len(warm)
        say(tag, f"prove_recursive chunk {ci}: {n} steps in {t_prove:.2f} s; "
            f"steps 2..{n} mean: synthesis {mean('synth_primary'):.1f} + "
            f"{mean('synth_secondary'):.1f} ms, device {mean('device'):.1f} "
            f"ms, commits {mean('commit'):.1f} ms, other host work "
            f"{mean('other'):.1f} ms, wall {mean('wall'):.1f} ms [{smi}]")
        t0 = time.perf_counter()
        require(prover.verify_recursive(rp, root) == root,
                "verify_recursive returned another root")
        say(tag, f"verify_recursive: {time.perf_counter() - t0:.2f} s "
            f"[{smi}]")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "rec.json")
            rp.save(path)
            say(tag, f"recursive chunk proof file: {os.path.getsize(path)} "
                "bytes")
            back = CP.RecursiveChunkProof.load(path)
        require(back.rec.to_dict() == rp.rec.to_dict(),
                "the saved recursive proof did not read back")

        def refused(what, change, want):
            bad = copy.deepcopy(back)
            change(bad)
            try:
                prover.verify_recursive(bad)
            except AssertionError as e:
                require(want in str(e), f"{what}: refused as {e}")
                say(tag, f"{what}: refused ({e})")
            else:
                require(False, f"a recursive proof with {what} verified")

        q = rs.q

        def swap(b):
            b.rec.U1.comm_W, b.rec.U1.comm_E = b.rec.U1.comm_E, \
                b.rec.U1.comm_W

        def bump_w(b):
            b.rec.W1[7] = (b.rec.W1[7] + 1) % q

        refused("chunk_idx changed",
                lambda b: setattr(b, "chunk_idx", b.chunk_idx ^ 1),
                "z0 mismatch")
        refused("z_final changed", lambda b: setattr(
            b.rec, "z_final", [(b.rec.z_final[0] + 1) % q]
            + b.rec.z_final[1:]), "primary state hash mismatch")
        refused("U1.comm_W and comm_E swapped", swap,
                "secondary state hash mismatch")
        refused("one entry of W1 changed", bump_w, "comm_W mismatch (primary)")
        say(tag, f"peak device memory of the full-width chain "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    have_ref = os.path.exists(RC.ref_path("toy"))
    for cyc, label in ((("pallas", "vesta"), RC.LABEL),
                       (("bn254", "grumpkin"), b"test-recursive-bn")):
        run = f"toy {cyc[0]}/{cyc[1]}"
        with capturing(seen, run), capturing_keys(seen, run):
            t0 = time.perf_counter()
            ts = RC.port_snark(cyc, label, device=dev)
            tp = ts.prove(RC.Z0, n_steps=RC.CHAINS["toy"][1])
            z = RC.Z0
            for _ in range(tp.n_steps):
                z = RC.toy_host(ts.q)(z)
            require(ts.verify(tp) == z, f"the {run} chain did not verify")
            msg = f"{run}: {tp.n_steps} steps proved with real commits and " \
                f"verified in {time.perf_counter() - t0:.1f} s (keys and " \
                "circuits included)"
            if cyc[0] == "pallas" and have_ref:
                ref = RC.load_ref("toy")
                require(json.dumps(tp.to_dict()) == json.dumps(ref),
                        "the port's toy recursive proof differs from the "
                        "reference's")
                require(ts.verify(type(tp).from_dict(ref)) == z,
                        "the reference's toy recursive proof did not verify")
                msg += "; byte-equal to the reference's proof (tests/data), " \
                    "which verifies"
            say(tag, msg + f" [{smi}]")
    torch.cuda.synchronize()
    counts = dict(MP.launches)
    say(tag, "launches (the BLAKE3 chain, its verify and tampers, the toy "
        "chains): " + ", ".join(f"{k} {counts[k]}" for k in RECURSIVE))
    for k in RECURSIVE:
        require(counts[k] > 0, f"{k} was not launched in the recursive phase")

    # One warm prove under the profiler: the 3-step chunk of CHUNK2_DATA.
    MP.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, pp = prover.prove_recursive(CHUNK2_DATA, 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    n_dev = sum(e.count for e in ev)
    n_p = pp.rec.n_steps
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)
    say(tag, f"profiled warm prove_recursive ({n_p} steps): wall {wall:.1f} "
        f"ms, device busy {busy:.1f} ms (idle share {1 - busy / wall:.3f}), "
        f"{n_dev} device events ({n_dev / n_p:.0f} a step), msm_bucket "
        f"{MP.launches['msm_bucket']} launches; top: " + ", ".join(
            f"{e.key[:36]} {e.self_device_time_total / 1e3:.1f} ms / "
            f"{e.count}" for e in top[:8]) + f" [{smi}]")
    require(prover.verify_recursive(pp) == _oracle_root(CHUNK2_DATA),
            "the profiled recursive proof did not verify")

    # The kernels against their plain versions on the phase's inputs.
    check_captured(seen, dev, note, tag)
    for (kind, where, n_pts), (label, *inp) in seen.items():
        t0 = time.perf_counter()
        if kind == "scale16":
            spec, pts, windows = inp
            note("scale16", MP.scale16(spec, pts, windows),
                 MP.scale16_plain(spec, pts, windows))
            k = pts.shape[0]
        elif kind == "to_affine":
            spec, X, Y, Z = inp
            xk, yk = MP.to_affine_words(spec, X, Y, Z)
            xp, yp = MP.to_affine_words_plain(spec, X, Y, Z)
            note("to_affine", xk, xp)
            note("to_affine", yk, yp)
            k = X.shape[0]
        else:
            continue
        torch.cuda.synchronize()
        say(tag, f"{label}: {kind} == plain on the first {k} of the "
            f"{n_pts} points of the {where} key preparation "
            f"({time.perf_counter() - t0:.1f} s)")
    commit_times(seen, rate, tag, smi)
    say(tag, f"phase {time.perf_counter() - t_phase:.1f} s [{smi}]; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, rp


@contextlib.contextmanager
def capturing_tables(seen: list):
    """While active, keep in seen the inputs of every h_tables call."""
    from hotproofs_tpu_torch.ops import tables as TB

    h_tables = TB.h_tables

    def rec(spec, csr, bases_lm, lpw):
        seen.append((spec, csr, bases_lm, lpw))
        return h_tables(spec, csr, bases_lm, lpw)

    TB.h_tables = rec
    try:
        yield
    finally:
        TB.h_tables = h_tables


def csr_rows(csr, rows: torch.Tensor):
    """The CSR of `rows` (ascending) of csr, each row's nonzeros in order,
    its lane alloc, and the rows in the order the whole call runs them:
    the kernel gives each row what it gives it within the whole."""
    from hotproofs_tpu_torch.ops import tables as TB

    rp = csr.row_ptr.to(torch.int64)
    lens = rp[rows + 1] - rp[rows]
    first = torch.cumsum(lens, 0) - lens
    idx = torch.repeat_interleave(rp[rows], lens) + (
        torch.arange(int(lens.sum()), device=rows.device)
        - torch.repeat_interleave(first, lens))
    rank = torch.empty_like(csr.order)
    rank[csr.order.long()] = torch.arange(csr.rows, dtype=rank.dtype,
                                          device=rank.device)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return TB.TableCSR(
        row_ptr=i32(torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])),
        order=i32(torch.argsort(rank[rows])), alloc=csr.alloc[rows]
        .contiguous(), cols=csr.cols[idx].contiguous(),
        mag=csr.mag[idx].contiguous(), neg=csr.neg[idx].contiguous())


def table_bound(csr, out: torch.Tensor, rate: float):
    """(bound_ms, bound_by, what) of h_tables on csr: a mixed add per
    nonzero digit and a complete add per distinct digit value of a row
    beyond its first; the CSR read once, the base points the digits touch
    (64 bytes each) read once, the tables written once."""
    from hotproofs_tpu_torch.ops import tables as TB

    mixed, joins, pts = TB.table_work(csr)
    nb = nbytes(csr.row_ptr, csr.order, csr.alloc, csr.cols, csr.mag,
                csr.neg, out) \
        + 64 * pts
    ms, by = bound(MONT_MIXED_ADD * mixed + MONT_ADD * joins, nb, rate)
    return ms, by, (f"{mixed} mixed adds, {joins} joins, {pts} base points, "
                    f"{csr.cols.shape[0]} nonzeros in {csr.rows} rows")


def rec_compress_phase(prover, rp, root, dev, note, stats, bounds, rate,
                       smi) -> dict:
    """Phase 11: the compressed recursive proof. With the launch counts
    set to 0: the phase-10 SNARK set up for compression on both sides
    (the matrix tables by h_tables), phase 10's BLAKE3 recursive proof
    compressed and verified, four tampers refused, the reference's toy
    chain (real commits) compressed and verified (byte-equal to the
    port's committed compressed proof where tests/data holds it), a
    BN254/Grumpkin toy chain proved, compressed and verified. Then
    h_tables against its plain version on a seeded sixteenth of the rows
    of each call, against the host fold_point loop on phase 9's chunk
    tables, and timed beside its bound. Returns the phase's launch
    counts."""
    import copy
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hotproofs_tpu_torch.models import chunk_prover as CP
    from hotproofs_tpu_torch.nova import recursive as R
    from hotproofs_tpu_torch.nova import spartan as SP
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.ops import tables as TB
    from hotproofs_tpu_torch.utils import telemetry as T_
    from hotproofs_tpu_torch.utils.config import CONFIG

    if TESTS_DIR not in sys.path:
        sys.path.append(TESTS_DIR)
    import test_torch_recursive_fixtures as RC
    from spartan_chains import host_tables

    tag = "11 rec-compress"
    counter = lambda k: T_.metrics.snapshot()["counters"].get(k, 0)
    seen: list = []
    rs = prover.recursive
    # Tables an earlier run cached on disk would skip the kernel.
    for name in os.listdir(CONFIG.cache_dir):
        if name.startswith("torch_spartanH_"):
            os.remove(os.path.join(CONFIG.cache_dir, name))
    MP.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    with capturing_tables(seen):
        for side in (rs.side1, rs.side2):
            sps = rs._spartan(side)
            t0 = time.perf_counter()
            sps.preprocess_H()
            torch.cuda.synchronize()
            t_h = time.perf_counter() - t0
            t0 = time.perf_counter()
            sps.setup()
            torch.cuda.synchronize()
            nnz = sum(len(getattr(side.shape, k).rows) for k in "ABC")
            say(tag, f"{side.name} ({side.curve.name}, m = {sps.m}, nz = "
                f"{sps.nz}, n_ipa_w = {sps.n_ipa_w}, nnz {nnz}): tables by "
                f"h_tables in {t_h:.2f} s (to_affine and the host copy "
                f"included); their {3 * sps.m} points and the key's bases "
                f"at the IPAs' lengths laid out in "
                f"{time.perf_counter() - t0:.2f} s [{smi}]")
        say(tag, f"device memory after setup: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # The main path: compress phase 10's proof, verify it.
        rounds = counter("spartan/ipa_rounds")
        t0 = time.perf_counter()
        cp = rs.compress(rp.rec)
        torch.cuda.synchronize()
        t_c = time.perf_counter() - t0
        for name, sp in (("sp1", cp.sp1), ("sp2", cp.sp2),
                         ("sp_u1", cp.sp_u1)):
            say(tag, f"{name}: " + ", ".join(
                f"{k} {v:.3f} s" for k, v in rs.compress_times[name].items())
                + "; IPA rounds L/W/E " + "/".join(
                    str(len(ipa.Ls)) for ipa in (sp.ipa_L, sp.ipa_W,
                                                 sp.ipa_E)))
        say(tag, f"compress of the {cp.n_steps}-step recursive proof: "
            f"{t_c:.2f} s, {counter('spartan/ipa_rounds') - rounds} IPA "
            f"rounds [{smi}]")
        t0 = time.perf_counter()
        z = rs.verify_compressed(cp)
        t_v = time.perf_counter() - t0
        require(z == rp.rec.z_final, "verify_compressed returned another "
                "z_final")
        CP.check_statement(prover.modulus, cp.z0, cp.n_steps, rp.chunk_idx,
                           rp.n_blocks, rp.leaf_depth, rp.total_depth)
        require(CP._proof_root(z, rp, root) == root,
                "the compressed proof's z_final gives another root")
        say(tag, f"verify_compressed: {t_v:.2f} s; the statement checked "
            f"by the caller, root {root.hex()[:16]}... [{smi}]")
        with tempfile.TemporaryDirectory() as tmp:
            full, small = (os.path.join(tmp, f) for f in ("r.json", "c.json"))
            rp.rec.save(full)
            cp.save(small)
            say(tag, f"proof files: recursive {os.path.getsize(full)} bytes, "
                f"compressed {os.path.getsize(small)} bytes")
            require(json.dumps(R.CompressedRecursiveProof.load(small)
                               .to_dict()) == json.dumps(cp.to_dict()),
                    "the saved compressed proof did not read back")

        def refused(what, change, want):
            bad = copy.deepcopy(cp)
            change(bad)
            try:
                rs.verify_compressed(bad)
            except AssertionError as e:
                require(want in str(e), f"{what}: refused as {e}")
                say(tag, f"{what}: refused ({e})")
            else:
                require(False, f"a compressed recursive proof with {what} "
                        "verified")

        q = rs.q

        def bump_L(b):
            b.sp_u1.ipa_W.Ls[3] = b.sp_u1.ipa_W.Rs[3]

        refused("z_final changed", lambda b: setattr(
            b, "z_final", [(b.z_final[0] + 1) % q] + b.z_final[1:]),
            "primary state hash mismatch")
        refused("sp1.vA changed", lambda b: setattr(
            b.sp1, "vA", (b.sp1.vA + 1) % q), "sum-check 1 final claim")
        refused("an IPA L point of sp_u1 changed", bump_L,
                "IPA opening of W failed")
        refused("u1.X[0] changed", lambda b: setattr(
            b.u1, "X", ((b.u1.X[0] + 1) % q, b.u1.X[1])),
            "primary state hash mismatch")

        # The toy chains: the reference's proof on Pasta, a fresh one on
        # BN254/Grumpkin.
        for cyc, label in ((("pallas", "vesta"), RC.LABEL),
                           (("bn254", "grumpkin"), b"test-recursive-bn")):
            run = f"toy {cyc[0]}/{cyc[1]}"
            ts = RC.port_snark(cyc, label, device=dev)
            if cyc[0] == "pallas":
                tp = R.RecursiveProof.from_dict(RC.load_ref("toy"))
            else:
                tp = ts.prove(RC.Z0, n_steps=RC.CHAINS["toy"][1])
            t0 = time.perf_counter()
            tc = ts.compress(tp)
            require(ts.verify_compressed(tc) == tp.z_final,
                    f"the {run} compressed proof did not verify")
            msg = f"{run}: compressed (tables and bases included) and " \
                f"verified in {time.perf_counter() - t0:.1f} s"
            if cyc[0] == "pallas" and os.path.exists(RC.compressed_path()):
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "c.json")
                    tc.save(path)
                    with open(path) as f, \
                            gzip.open(RC.compressed_path(), "rt") as g:
                        require(f.read() == g.read(),
                                "the toy compressed proof differs from the "
                                "committed one")
                msg += "; byte-equal to the committed compressed proof " \
                    "(tests/data)"
            say(tag, msg + f" [{smi}]")
    torch.cuda.synchronize()
    counts = dict(MP.launches)
    say(tag, "launches (setup, compress, verify, tampers, toy chains): "
        + ", ".join(f"{k} {counts[k]}" for k in REC_COMPRESS))
    for k in REC_COMPRESS:
        require(counts[k] > 0, f"{k} was not launched in phase 11")

    # One warm Spartan argument of the compress, sp2 (the secondary's, the
    # smallest of the three), under the profiler: its device events alone,
    # since key_averages over a whole compress's 200,000 launches with
    # their host events takes minutes.
    sp2_sys, i2 = rs._spartan(rs.side2), rs._instances(rp.rec)[1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sp2_sys.prove_relaxed(i2, rp.rec.W2, rp.rec.E2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    require(busy > 0, "the profiler saw no device time")
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)
    say(tag, f"profiled warm argument sp2: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms (idle share {1 - busy / wall:.3f}), "
        f"{sum(e.count for e in ev)} device events; top: " + ", ".join(
            f"{e.key[:36]} {e.self_device_time_total / 1e3:.1f} ms / "
            f"{e.count}" for e in top[:6]) + f" [{smi}]")

    # h_tables against its plain version on a slice of the rows of the
    # BLAKE3 sides' calls, then timed whole and on the slice.
    rng = np.random.default_rng(11)
    for spec, csr, bl, lpw in seen[:2]:
        full = TB.h_tables(spec, csr, bl, lpw)
        n = (csr.row_ptr[1:] - csr.row_ptr[:-1]).to(torch.int64)
        pick = rng.choice(csr.rows, csr.rows // TABLE_SLICE, replace=False)
        rows = torch.unique(torch.cat([
            torch.from_numpy(pick).to(dev),
            torch.argsort(n, descending=True)[:8]]))
        part = csr_rows(csr, rows)
        got = TB.h_tables(spec, part, bl, lpw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = TB.h_tables_plain(spec, part, bl, lpw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        note("h_tables", got, want)
        note("h_tables", full[rows], want)
        ms = cuda_ms(lambda: TB.h_tables(spec, part, bl, lpw), 3)
        bnd = table_bound(part, got, rate)
        ms_full = cuda_ms(lambda: TB.h_tables(spec, csr, bl, lpw), 3)
        bnd_full = table_bound(csr, full, rate)
        walk, join = TB.table_steps(csr)
        cycles = ms_full * 1e-3 * rate / IMUL_PER_CLOCK_SM / (walk + join)
        say(tag, f"h_tables == plain on {rows.shape[0]} rows of "
            f"{spec.name}'s {csr.rows} (a seeded sixteenth and the 8 "
            f"longest), and the whole call's rows equal the slice's: slice "
            f"{ms:.3f} ms (plain {plain_ms:.1f} ms, bound {bnd[0]:.4f} ms "
            f"by {bnd[1]}: {bnd[2]}); whole {ms_full:.3f} ms (bound "
            f"{bnd_full[0]:.4f} ms by {bnd_full[1]}, "
            f"{100 * bnd_full[0] / ms_full:.1f} % of it: {bnd_full[2]}); "
            f"lane map: {walk} walk + {join} join warp-steps, {cycles:.0f} "
            f"SM cycles a warp-step [{smi}]")
        if spec.name == rs.side1.curve.name:
            stats["h_tables"]["ms"] = ms
            stats["h_tables"]["plain_ms"] = plain_ms
            bounds["h_tables"] = bnd[:2]
        del full, got, want

    # The kernel against the host loop on phase 9's whole chunk tables.
    sps9 = SP.SpartanSystem(prover.ivc)
    t0 = time.perf_counter()
    kern = sps9._build_H()
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = host_tables(sps9.shape, sps9.ck, sps9.m)
    t_host = time.perf_counter() - t0
    for a, b in zip(kern, host):
        note("h_tables", torch.from_numpy(a.astype(np.int32)),
             torch.from_numpy(b.astype(np.int32)))
    nnz = sum(len(getattr(sps9.shape, k).rows) for k in "ABC")
    say(tag, f"phase 9's chunk tables ({nnz} nonzeros, m = {sps9.m}): "
        f"h_tables + to_affine {t_k:.2f} s == the host fold_point loop "
        f"{t_host:.1f} s, exactly [{smi}]")
    say(tag, f"phase {time.perf_counter() - t_phase:.1f} s [{smi}]; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"h_tables": counts["h_tables"]}


def steps_mesh_phase(prover, data, ci, proof, many, root, dev, note, rng,
                     smi) -> None:
    """Phase 12: the per-step prover, checkpoints with resume and a
    one-rank NCCL mesh on phase 4's chunk at full width, each byte-equal
    to phase 4's proofs; the phase's launch counts (msm_bucket, msm_merge,
    msm_wsum and mont_mul must be > 0), then those kernels against their
    plain versions on the first commit and to_mont inputs of the phase."""
    import socket
    import tempfile

    from hotproofs_tpu_torch.nova import ivc as I
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.parallel import mesh as M
    from hotproofs_tpu_torch.parallel.msm_sharded import msm_sharded

    tag = "12 steps+mesh"
    text = lambda p: json.dumps(p.to_dict())
    seen: dict = {}
    ivc = prover.ivc
    MP.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    with capturing(seen, "per-step"):
        t0 = time.perf_counter()
        root_s, slow = prover.prove(data, ci, fast=False)
        dt = time.perf_counter() - t0
    n = slow.ivc_proof.num_steps
    require(root_s == root and text(slow) == text(proof),
            "the per-step proof differs from phase 4's")
    t0 = time.perf_counter()
    require(prover.verify(slow) == root, "verify returned another root")
    say(tag, f"prove(fast=False) chunk {ci}: {n} steps in {dt:.2f} s "
        f"({n / dt:.3f} folds/s), byte-equal to phase 4's proof; verify "
        f"{time.perf_counter() - t0:.2f} s [{smi}]")
    tm = ivc.timings
    for a in range(0, n, 8):
        say(tag, "ms a step (host witness / device / commit / host): " +
            "; ".join(f"{a + i}: {t['witness']:.0f} / {t['device']:.0f} / "
                      f"{t['commit']:.0f} / {t['host']:.0f}"
                      for i, t in enumerate(tm[a:a + 8])))
    say(tag, "mean ms a step: " + ", ".join(
        f"{k} {sum(t[k] for t in tm) / n:.1f}" for k in tm[0]))

    _, sched, canon, X = prover._device_witness_chain(
        prover._hash_with_path(data, ci))
    saves, save_ms = [], []
    checkpoint = ivc._checkpoint

    def timed_checkpoint(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp = checkpoint(*a)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        saves.append(cp.next_step)
        return cp

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.json")
        ivc._checkpoint = timed_checkpoint
        try:
            with capturing(seen, "checkpointed"):
                t0 = time.perf_counter()
                whole = ivc.prove_batch(sched.z0, canon, X,
                                        checkpoint_every=8,
                                        checkpoint_path=path)
                dt = time.perf_counter() - t0
        finally:
            del ivc._checkpoint
        require(saves == [8, 16, 24], f"checkpoints after folds {saves}")
        require(text(whole) == text(proof.ivc_proof),
                "the checkpointed chain differs from phase 4's")
        t0 = time.perf_counter()
        cp = I.ProverCheckpoint.load(path)
        t_load = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cp.save(os.path.join(tmp, "again.json"))
        t_write = (time.perf_counter() - t0) * 1e3
        fresh = I.IVC(ivc.shape, ivc.curve, ivc.ck, ivc.big_wit_idx,
                      label=ivc.label)
        t0 = time.perf_counter()
        resumed = fresh.prove_batch(sched.z0, canon, X, resume=cp)
        t_res = time.perf_counter() - t0
        require(text(resumed) == text(proof.ivc_proof),
                "the resumed chain differs from phase 4's")
        say(tag, f"prove_batch with checkpoint_every=8: {dt:.2f} s, saves "
            f"after folds {saves} (state to ints "
            + ", ".join(f"{v:.1f}" for v in save_ms) + " ms, file write "
            f"{t_write:.1f} ms, {os.path.getsize(path)} bytes); load "
            f"{t_load:.1f} ms; a fresh "
            f"IVC resumed at fold {cp.next_step} in {t_res:.2f} s, "
            f"byte-equal to phase 4's proof [{smi}]")
        cp.pp_digest = (cp.pp_digest + 1) % prover.modulus
        try:
            fresh.prove_batch(sched.z0, canon, X, resume=cp)
        except AssertionError as e:
            require("different circuit/key" in str(e), f"refused: {e}")
            say(tag, f"a checkpoint with a changed pp_digest refused ({e})")
        else:
            require(False, "a checkpoint for another pp digest resumed")

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {"HOTPROOFS_COORDINATOR": f"127.0.0.1:{port}",
           "HOTPROOFS_NUM_PROCESSES": "1", "HOTPROOFS_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        rank = M.init_distributed()
        mesh = M.make_mesh(1, 1)
        chain_mesh = M.make_chain_mesh()
        require(rank == 0 and torch.distributed.get_backend() == "nccl",
                "the one-rank group is not NCCL")
        say(tag, f"one-rank NCCL group and meshes in "
            f"{time.perf_counter() - t0:.2f} s: {mesh}, {chain_mesh}")
        with capturing(seen, "mesh"):
            t0 = time.perf_counter()
            _, on_mesh = prover.prove(data, ci, mesh=mesh)
            dt = time.perf_counter() - t0
            require(text(on_mesh) == text(proof),
                    "prove_batch(mesh=) differs from phase 4's proof")
            chains = []
            for p in many:
                _, sch, cn, Xp = prover._device_witness_chain(
                    prover._hash_with_path(data, p.chunk_idx))
                chains.append((sch.z0, cn, Xp))
            t0 = time.perf_counter()
            lock = ivc.prove_lockstep(chains, mesh=chain_mesh)
            dl = time.perf_counter() - t0
        require([text(p) for p in lock] ==
                [text(p.ivc_proof) for p in many],
                "prove_lockstep(mesh=) differs from phase 4's prove_many")
        m = ivc.shape.n_cons
        raw = rng.integers(0, 256, size=(m, 32), dtype=np.int64)
        raw[:, 31] &= 0x3F
        sc = torch.from_numpy(raw.astype(np.int32)).to(dev)
        got = ivc.ck.affine(tuple(c[None] for c in msm_sharded(
            ivc.ck, mesh, sc, 256)))
        require(got == ivc.ck.affine(ivc.ck.commit_many(sc[None], 256)),
                "msm_sharded != msm_many at the comm_T shape")
        say(tag, f"prove(mesh=1x1) chunk {ci}: {dt:.2f} s, byte-equal to "
            f"phase 4's proof; prove_lockstep(mesh=chain of 1) K=2: "
            f"{dl:.2f} s, byte-equal to phase 4's prove_many; msm_sharded "
            f"at the comm_T shape (m = {m}, 256 bits) == msm_many [{smi}]")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    torch.cuda.synchronize()
    counts = dict(MP.launches)
    say(tag, f"phase {time.perf_counter() - t_phase:.1f} s [{smi}]; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB; launches " + ", ".join(f"{k} {counts[k]}" for k in MAIN))
    for k in ("msm_bucket", "msm_merge", "msm_wsum", "mont_mul"):
        require(counts[k] > 0, f"{k} was not launched in phase 12")
    check_captured(seen, dev, note, tag)


def field_phase(prover, dev, rng, note, stats, bounds) -> dict:
    """Phase 7: the four field-multiply kernels against their plain
    versions in three fields, mont_mul at the prover's own shapes, then
    the run of tools/field_mul.py over prover's key. Records the kernels'
    times and bounds in stats and bounds (mont_mul: the prover's to_mont
    of one 16-step witness chunk; the others: the tool's N = 131,072 lines
    of stage 5, the conv part and conv_mma); returns their launch counts
    during the tool's run."""
    from hotproofs_tpu_torch.ops import field as F
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.ops import pallas_field as PF
    from hotproofs_tpu_torch.tools import field_mul as FM

    n = 1037                                  # no multiple of 512, 128 or 8
    for spec in (F.pallas_base, F.vesta_base, F.bn254_base):
        a, b = (FM.random_elements(rng, spec, n, dev) for _ in range(2))
        edge = torch.from_numpy(spec.batch_to_limbs(
            [0, spec.p - 1, 1, 0, spec.p - 1, spec.p - 1])).to(dev)
        a[:3], b[:3] = edge[:3], edge[3:]
        at, bt = a.T.contiguous(), b.T.contiguous()
        aw, bw = F.digits_to_words(a), F.digits_to_words(b)
        a3 = a[:1020].reshape(4, 255, 32)
        want = PF.mont_mul_em_plain(spec, a, b)
        note("mont_mul", PF.mont_mul_em(spec, a, b), want)
        note("mont_mul", PF.mont_mul_lm(spec, at, bt), want.T)
        note("mont_mul", PF.mont_mul_words(spec, aw, bw),
             PF.mont_mul_words_plain(spec, aw, bw))
        for x, y in ((a3, b[7]), (a3, b[:255]), (a3[:, ::2], b[:128]),
                     (a3, b[:4].reshape(4, 1, 32))):
            note("mont_mul", PF.mont_mul_em(spec, x, y),
                 PF.mont_mul_em_plain(spec, x, y))
        note("mont_mul", F.from_mont(spec, F.to_mont(spec, a)), a)
        for stage in PF.STAGES:
            note("mont_mul_stage", PF.mont_mul_stage(spec, at, bt, stage),
                 PF.mont_mul_stage_plain(spec, at, bt, stage))
        note("mont_mul_stage", PF.mont_mul_stage(spec, at, bt, 5), want.T)
        for part in PF.PARTS:
            note("mont_mul_part", PF.mont_mul_part(spec, at, bt, part),
                 PF.mont_mul_part_plain(spec, at, bt, part))
        got = PF.conv_mma(at, bt)
        note("conv_mma", got, PF.conv_mma_plain(at, bt))
        note("conv_mma", got & 0xFF, PF.mont_mul_part(spec, at, bt, "conv"))
        torch.cuda.synchronize()
        say("7 kernels", f"{spec.name} (n={n}, edge lanes): mont_mul (em, "
            "lm, words, broadcasts), stages 1-5, parts conv/conv3/norm, "
            "conv_mma == plain")

    # mont_mul at the prover's shapes, in the circuit's field: the to_mont
    # of one 16-step witness chunk and the from_mont of a cross term.
    shape = prover.ivc.shape
    spec = shape.field
    rate = FM.imul_rate(dev)
    for tag, dims, op, const in (
            ("to_mont", (16, shape.n_vars), F.to_mont, "r2"),
            ("from_mont", (1, shape.n_cons), F.from_mont, "unit")):
        x = FM.random_elements(rng, spec, dims[0] * dims[1], dev).reshape(
            *dims, 32)
        c = PF.const_digits(spec, const, dev)
        got = op(spec, x)
        t0 = time.perf_counter()
        want = PF.mont_mul_em_plain(spec, x, c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        note("mont_mul", got, want)
        ms = FM.kernel_ms(dev, lambda i: op(spec, x), 20)
        # the constant is one element: 128 bytes in all, read once
        bnd = FM.bound(1, FM.MULS["mont_mul"] * x[..., 0].numel(),
                       nbytes(x, got, c), rate)
        say("7 times", f"{tag} of {dims[0]} x {dims[1]} elements "
            f"({spec.name}): mont_mul {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"bound {bnd[0]:.4f} ms by {bnd[1]})")
        if tag == "to_mont":
            stats["mont_mul"]["ms"], stats["mont_mul"]["plain_ms"] = \
                ms, plain_ms
            bounds["mont_mul"] = bnd
    del x, got, want
    torch.cuda.empty_cache()

    MP.reset_launches()
    res = FM.run(dev, rng, ck=prover.ivc.ck,
                 out=lambda line: say("7 field_mul", line))
    torch.cuda.synchronize()
    counts = {k: MP.launches[k] for k in FIELD}
    require(FM.all_ok(res), "a field-multiply kernel, stage or part "
            "disagrees with its plain version, or an MSM with the host")
    rows = res[f"N={FM.NS[-1]}"]
    for k, line in (("mont_mul_stage", "stage 5"), ("mont_mul_part", "conv"),
                    ("conv_mma", "conv_mma")):
        stats[k]["ms"] = rows[line]["ms"]
        stats[k]["plain_ms"] = rows[line]["plain_ms"]
        bounds[k] = (rows[line]["bound_ms"], rows[line]["bound_by"])
    # conv_mma's library call: a grouped float32 conv1d (tools/field_mul.py
    # library_conv), kept only where its columns equal the kernel's
    lib_row = rows["conv1d (library)"]
    stats["conv_mma"]["library_ms"] = lib_row["ms"] if lib_row["exact"] \
        else None
    say("7 library", f"N={FM.NS[-1]}: conv1d (groups={FM.NS[-1]}, float32, "
        f"no TF32) {lib_row['ms']:.4f} ms, its columns == conv_mma's: "
        f"{lib_row['exact']}; conv_mma {rows['conv_mma']['ms']:.4f} ms")
    say("7 launches", ", ".join(f"{k} {counts[k]}" for k in FIELD))
    for k in FIELD:
        require(counts[k] > 0, f"{k} was not launched on the field-multiply "
                "path")
    return counts


def poseidon_specs():
    """Phase 13's specs: the Pasta transcript fields under both
    parameterisations, the BN254 cycle's fields, and the Pallas scalar
    field at t = 5 and 9 (the kernel's other widths)."""
    from hotproofs_tpu_torch.ops import poseidon as P
    return [P.make_spec("pallas_scalar"), P.make_spec("vesta_scalar"),
            P.make_spec_neptune("pallas_scalar", 2),
            P.make_spec_neptune("vesta_scalar", 2),
            P.make_spec("bn254_scalar"), P.make_spec("grumpkin_scalar"),
            P.make_spec("pallas_scalar", t=5),
            P.make_spec("pallas_scalar", t=9)]


def poseidon_muls(spec) -> int:
    """32-bit multiplies of one permutation by the least known method, the
    Poseidon paper's optimised partial rounds (as neptune runs them): a
    full round's S-boxes on t lanes (x^2, x^4: squarings; x^5: a product)
    and its t^2 MDS products; a partial round's S-box on one lane and a
    sparse matrix of 2t - 1 products; one dense t^2 product where the
    partial rounds begin. The kernel does t^2 a partial round."""
    sbox = 2 * MUL32_PER_SQUARE + MUL32_PER_MONT
    mds = spec.t * spec.t * MUL32_PER_MONT
    return spec.r_full * (spec.t * sbox + mds) + mds + \
        spec.r_partial * (sbox + (2 * spec.t - 1) * MUL32_PER_MONT)


def poseidon_phase(dev, rng, note, stats, bounds, rate, smi) -> int:
    """Phase 13: the batched Poseidon permutation. With the launch counts
    set to 0, ops/poseidon.permute of POSEIDON_N seeded states in each of
    the eight specs (the phase's main path; returns its launches of
    poseidon_permute); then each output against the plain version (every
    state for the Pasta default specs, the first POSEIDON_CHECK of the
    others) and 16 states against host_permute; the kernel's and plain
    times beside the bound, the latency of one state; launches under
    on-demand traces and a span, here and in a process of its own."""
    from hotproofs_tpu_torch.ops import field as F
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.ops import poseidon as P
    from hotproofs_tpu_torch.tools import field_mul as FM
    from hotproofs_tpu_torch.tools import trace_check as TC
    from hotproofs_tpu_torch.utils import telemetry as T_

    tag = "13 poseidon"
    specs = poseidon_specs()
    states = [FM.random_elements(rng, s.field, POSEIDON_N * s.t, dev)
              .reshape(POSEIDON_N, s.t, 32) for s in specs]
    for s in specs:                       # constants on the card, untimed
        P.permute(s, torch.zeros((1, s.t, 32), dtype=torch.int32,
                                 device=dev))
    torch.cuda.synchronize()
    MP.reset_launches()
    outs = [P.permute(s, x) for s, x in zip(specs, states)]
    torch.cuda.synchronize()
    launches = MP.launches["poseidon_permute"]
    require(launches == len(specs), f"poseidon_permute launched {launches} "
            f"times for {len(specs)} permute calls")

    for i, (s, x, out) in enumerate(zip(specs, states, outs)):
        name = f"{s.field.name} t={s.t} ({s.r_full}, {s.r_partial})"
        n = POSEIDON_N if i < 2 else POSEIDON_CHECK
        t0 = time.perf_counter()
        want = P.permute_plain(s, x[:n])
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        note("poseidon_permute", out[:n], want)
        del want
        ints = F.to_ints(s.field, x[:16], mont=True)
        got = F.to_ints(s.field, out[:16], mont=True)
        host = [P.host_permute(s, ints[k * s.t:(k + 1) * s.t])
                for k in range(16)]
        require(got == [v for row in host for v in row],
                f"poseidon_permute != host_permute ({name})")
        ms = cuda_ms(lambda: P.permute(s, x), 5)
        # the states in and out, and the constants' words (rc, then mds)
        bnd = bound(POSEIDON_N * poseidon_muls(s) / MUL32_PER_MONT,
                    nbytes(x, out) + 32 * (s.n_rounds + s.t) * s.t, rate)
        say(tag, f"{name}: == plain on {n} states (plain {plain:.1f} ms), "
            f"== host_permute on 16; N={POSEIDON_N}: {ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms by {bnd[1]} ({poseidon_muls(s)} multiplies "
            f"a permutation), {100 * bnd[0] / ms:.1f} % of it [{smi}]")
        if i == 0:
            stats["poseidon_permute"].update(ms=ms, plain_ms=plain)
            bounds["poseidon_permute"] = bnd
            one = x[:1].clone()
            P.permute(s, one)
            lat = cuda_ms(lambda: P.permute(s, one), 5)
            say(tag, f"{name}: one state (a random-oracle call) "
                f"{lat:.4f} ms [{smi}]")
        torch.cuda.empty_cache()

    # The on-demand capture. In this process, minutes old, a capture can
    # lose kernel records (PERF.md §7); stop_trace must then say so: a
    # trace without the kernel whose loss went unreported fails. A process
    # of its own (tools/trace_check.py) must keep every record.
    x = states[0][:1024]
    here = [TC.capture_once(x, "smoke/poseidon") for _ in range(4)]
    require(all(t["span"] and t["timed"] and t["returned"] for t in here),
            f"a capture in this process missed the span or its timer: {here}")
    require(all(t["launched"] == 1 and t["launches"] >= 1 for t in here),
            f"a capture in this process missed the host's launch: {here}")
    require(all(t["kernel"] or t["lost"] >= 1 for t in here),
            f"a capture lost the kernel's record unreported: {here}")
    require(T_.stop_trace() is None, "a second stop_trace did not give None")
    timer = T_.metrics.snapshot()["timers"]["smoke/poseidon"]
    say(tag, f"on-demand captures in this process: the span named and timed "
        f"in 4 of 4, the kernel named in {sum(t['kernel'] for t in here)} "
        f"of 4, records reported lost (lost of launches) "
        f"{[(t['lost'], t['launches']) for t in here]}; span timer {timer}")
    res = subprocess.run(
        [sys.executable, "-m", "hotproofs_tpu_torch.tools.trace_check"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    out = res.stdout.strip().splitlines()
    require(res.returncode == 0, f"tools/trace_check.py failed (exit "
            f"{res.returncode}): {out[-1:]} {res.stderr[-2000:]}")
    fresh = json.loads(out[-1])["trials"]
    say(tag, f"tools/trace_check.py in a process of its own: {len(fresh)} "
        "captures, each names k_poseidon and the span, no kernel record "
        "lost, its timer counted once "
        f"({[t['bytes'] for t in fresh]} bytes)")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2

    from hotproofs_tpu_torch.core import native
    from hotproofs_tpu_torch.models.chunk_prover import ChunkProver
    from hotproofs_tpu_torch.nova.ivc import IVCProof
    from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
    from hotproofs_tpu_torch.ops import cuda_lib
    from hotproofs_tpu_torch.ops import curve as C
    from hotproofs_tpu_torch.ops import field as F
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.tools import msm_designs as D
    from hotproofs_tpu_torch.tools import wsum_affine as WA
    from hotproofs_tpu_torch.utils.config import CONFIG

    dev = torch.device("cuda")
    spec = C.PALLAS
    rng = np.random.default_rng(args.seed)

    # -- 1. card and toolchain ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    nv = subprocess.run([cuda_lib.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    say("1 card", f"{smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {nv[-1]} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * IMUL_PER_CLOCK_SM * mhz * 1e6
    say("1 card", f"bound rates: {sms} SMs x {IMUL_PER_CLOCK_SM} x "
        f"{mhz:.0f} MHz = {rate / 1e12:.3f} T 32-bit multiplies/s; "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    bounds = {}

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.lib()
    units = cuda_lib.build_info.get("unit_seconds", {})
    say("2 build", f"kernels loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_lib.build_info.get('seconds', 0.0):.1f} s; units in "
        "parallel: " + ", ".join(f"{u} {s:.1f} s" for u, s in units.items())
        + f") from {os.path.relpath(cuda_lib.build_info['path'])}")
    for line in cuda_lib.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "stack frame" in line or \
                "Compiling entry" in line:
            say("2 build", "ptxas: " + line.strip())

    # -- 3. kernels vs plain versions on the card -----------------------------
    stats = {k: {"max_abs_err": 0} for k in KERNELS}
    t0 = time.perf_counter()
    key = CommitmentKey.create(spec, b"blake3-nova", 16384, dev)
    say("3 kernels", f"commitment key ({key.n} generators) in "
        f"{time.perf_counter() - t0:.1f} s")
    # A label-less key over the same generators: no disk cache, so the
    # main path below prepares its own bases through the kernel.
    tmp_key = CommitmentKey(spec, key.n, key.gens_affine, b"", dev)

    def note(name, a, b):
        e = max_err(a, b)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], e)
        require(e == 0, f"{name}: kernel != plain (max |err| {e})")

    # to_affine on 13,312 projective points (208 generators x 64 windows,
    # 3 1/4 of the kernel's blocks). A Z of 0 gives (0, 0), at one point,
    # at every point of a thread of block 0, at every point of block 1 and
    # of a thread of the last block, which ends mid-thread.
    pts = tuple(c[:208] for c in tmp_key.points)
    X, Y, Z = (F.digits_to_words(c.reshape(-1, 32))
               for c in MP.scale_points16(spec, pts, 64))
    T, blk = MP.AFFINE_THREADS, MP.AFFINE_BLOCK
    zero = [5] + [k * T + 7 for k in range(MP.AFFINE_PER_THREAD)] + \
        list(range(blk, 2 * blk)) + [3 * blk + k * T + 3 for k in range(4)]
    Z[zero] = 0
    xk, yk = MP.to_affine_words(spec, X, Y, Z)
    xp, yp = MP.to_affine_words_plain(spec, X, Y, Z)
    torch.cuda.synchronize()
    note("to_affine", xk, xp)
    note("to_affine", yk, yp)
    require(not bool(xk[zero].any()) and not bool(yk[zero].any()),
            "to_affine: a zero Z did not give (0, 0)")
    say("3 kernels", f"to_affine == plain on {X.shape[0]} points "
        f"({X.shape[0] / blk:.2f} blocks of {blk}; {len(zero)} zero Z: one "
        "point, a thread's 16, block 1, a thread of the last block)")

    # msm_wsum at every lane count G: seeded random slots, a tenth of them
    # the identity, job 0 all identity.
    for S in (1, 2, 3, 8, 15, 16, 17, 32):
        for J in (0, 1, 3, 256):
            red = WA.random_reduced(rng, J, S, dev)
            if J:
                red[0] = 0
                red[0, :, 1] = F.digits_to_words(torch.from_numpy(
                    spec.base.one_mont_limbs).to(dev))
            got = MP.msm_wsum(spec, red)
            note("msm_wsum", got, MP.msm_wsum_plain(spec, red))
            require(J == 0 or not bool(got[0, 2].any()),
                    "msm_wsum: an all-identity job did not sum to it")
    say("3 kernels", "msm_wsum == plain at S = 1, 2, 3, 8, 15, 16, 17, 32 "
        "(G = 1 to 32 lanes a job) and J = 0, 1, 3, 256; all-identity jobs "
        "sum to the identity")

    def chain_check(scalars, bases, m, bits, tag):
        """bucket, merge and wsum == plain on scalars; a job of zero
        scalars must leave every bucket and slot the identity (Z = 0)."""
        b, lpw, w4, n_lanes = MP.plan(m, bits)
        d = MP.digits_tm(scalars, m, b, lpw, w4)
        bk = MP.msm_bucket(spec, d, bases)
        note("msm_bucket", bk, MP.msm_bucket_plain(spec, d, bases))
        red = MP.msm_merge(spec, bk)
        note("msm_merge", red, MP.msm_merge_plain(spec, bk))
        s = MP.msm_wsum(spec, red)
        note("msm_wsum", s, MP.msm_wsum_plain(spec, red))
        torch.cuda.synchronize()
        zero = [j for j in range(scalars.shape[0])
                if not bool(scalars[j].any())]
        for j in zero:
            require(not bool(bk[j, :, 2].any()) and not bool(red[j, :, 2]
                                                         .any()),
                    f"{tag}: the zero job {j} left a nonempty bucket")
        G = MP.merge_group(*bk.shape[:2], n_lanes)
        empty = float((bk[:, :, 2] == 0).all(dim=2).float().mean())
        say("3 kernels", f"{tag}: bucket, merge, wsum == plain "
            f"(J={scalars.shape[0]}, m={m}, {bits} bits, B={b}, "
            f"{n_lanes} lanes; merge G={G} threads a slot, "
            f"{max(G // MP.MERGE_THREADS, 1)} blocks a slot, lanes mod G = "
            f"{n_lanes % G}; empty buckets {empty:.4f}; zero jobs {zero} "
            "all identity)")
        return d, bk, red

    m = 1000
    for tag, bits in (("seeded 40", 40), ("seeded 256", 256),
                      ("seeded 40, sparse", 40)):
        raw = rng.integers(0, 256, size=(3, m, 32), dtype=np.int64)
        if tag.endswith("sparse"):   # 5 % of the points, low byte only:
            raw[:, rng.random(m) >= 0.05] = 0       # most buckets empty
            raw[..., 1:] = 0
        raw[..., (bits + 7) // 8:] = 0
        raw[:, :, 31] &= 0x3F                       # < 2^254 < group order
        raw[1] = 0                                  # all-zero job
        sc = torch.from_numpy(raw.astype(np.int32)).to(dev)
        chain_check(sc, tmp_key.bases(m, bits), m, bits, tag)
        got = tmp_key.affine(MP.msm_many(spec, sc, tmp_key.bases(m, bits),
                                         m, bits))
        require(got[1] is None, "all-zero job must give the identity")
        require(all(C.host_on_curve(spec, p) for p in got),
                "MSM result off the curve")

    # Key preparation at the main path's shape: 64 windows x 16,162
    # points through to_affine, held against the plain version, and timed.
    P3 = tuple(F.digits_to_words(c.reshape(-1, 32)) for c in
               MP.scale_points16(spec, tuple(c[:16162]
                                             for c in tmp_key.points), 64))
    xk, yk = MP.to_affine_words(spec, *P3)
    t0 = time.perf_counter()
    xp, yp = MP.to_affine_words_plain(spec, *P3)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    note("to_affine", xk, xp)
    note("to_affine", yk, yp)
    ms = cuda_ms(lambda: MP.to_affine_words(spec, *P3), 3)
    stats["to_affine"]["ms"], stats["to_affine"]["plain_ms"] = ms, plain
    n_pts = P3[0].shape[0]
    inv_monts = 256 + bin(spec.base.p - 2).count("1") + 2
    bounds["to_affine"] = bound(n_pts * MONT_AFFINE + inv_monts,
                                nbytes(*P3, xk, yk), rate)
    one = tuple(c[:MP.AFFINE_BLOCK] for c in P3)
    floor = cuda_ms(lambda: MP.to_affine_words(spec, *one), 5)
    say("3 times", f"to_affine on {n_pts} points: {ms:.3f} ms "
        f"(plain {plain:.1f} ms); on one block's {MP.AFFINE_BLOCK} points, "
        f"the latency of one Fermat chain: {floor:.3f} ms "
        f"({ms / floor:.2f}x of it)")
    tmp_key._scaled[(16162, 64)] = tuple(
        F.words_to_digits(a).reshape(64, 16162, 32) for a in (xk, yk))
    del P3, xp, yp

    # MSM chain times at the main path's shapes (kernel mean of 5 runs;
    # plain run once).
    shapes = {"comm_T J=1": (1, 16162, 256), "comm_T J=2": (2, 16162, 256),
              "W J=16": (16, 15922, 40)}
    for tag, (J, mm, bits) in shapes.items():
        raw = rng.integers(0, 256, size=(J, mm, 32), dtype=np.int64)
        raw[..., (bits + 7) // 8:] = 0
        raw[:, :, 31] &= 0x3F
        sc = torch.from_numpy(raw.astype(np.int32)).to(dev)
        bases, lm = tmp_key.bases(mm, bits), tmp_key.bases_lm(mm, bits)
        d, bk, red = chain_check(sc, bases, mm, bits, tag)
        times = {}
        for name, kern, plain in (
                ("msm_bucket", lambda: MP.msm_bucket(spec, d, bases, lm),
                 lambda: MP.msm_bucket_plain(spec, d, bases)),
                ("msm_merge", lambda: MP.msm_merge(spec, bk),
                 lambda: MP.msm_merge_plain(spec, bk)),
                ("msm_wsum", lambda: MP.msm_wsum(spec, red),
                 lambda: MP.msm_wsum_plain(spec, red))):
            kern()
            times[name] = (cuda_ms(kern, 5), cuda_ms(plain, 1))
            if tag == "comm_T J=1":
                stats[name]["ms"], stats[name]["plain_ms"] = times[name]
        if tag == "comm_T J=1":
            live = int((d != 0).sum())
            S = bk.shape[1]
            bounds["msm_bucket"] = bound(MONT_MIXED_ADD * live,
                                         nbytes(d, bases, bk), rate)
            least, by, trees = merge_bound(bk, red, rate)
            bounds["msm_merge"] = (least, by)
            say("3 times", f"{tag}: msm_merge bound {least:.4f} ms (one add "
                "fewer than the nonempty buckets of each slot); "
                f"{trees:.4f} ms counting the block trees and finish in full")
            bounds["msm_wsum"] = bound(MONT_ADD * J * 2 * S,
                                       nbytes(red) + J * 3 * 8 * 4, rate)
        chain = cuda_ms(lambda: MP.msm_many(spec, sc, bases, mm, bits,
                                            bases_lm=lm), 5)
        say("3 times", f"{tag}: " + ", ".join(
            f"{k} {v[0]:.3f} ms (plain {v[1]:.1f} ms)"
            for k, v in times.items()) + f"; whole msm_many {chain:.3f} ms")
        say("3 times", f"{tag}: " + wsum_path(times["msm_wsum"][0],
                                               bk.shape[1]))
    del tmp_key
    torch.cuda.empty_cache()
    # Bases cached on disk by an earlier run would let the main path skip
    # its key preparation; drop them so it runs through to_affine.
    for name in os.listdir(CONFIG.cache_dir):
        if name.startswith("torch_scaledaff_pallas_blake3-nova_"):
            os.remove(os.path.join(CONFIG.cache_dir, name))

    # -- 4. the main path ----------------------------------------------------
    data = rng.bytes(FILE_BYTES)
    n_chunks = FILE_BYTES // 1024
    ci, cj = int(rng.integers(n_chunks)), n_chunks - 1
    # The pure-Python oracle hashes the file in a second process meanwhile.
    with mp.get_context("spawn").Pool(1) as pool:
        oracle = pool.apply_async(_oracle_root, (data,))
        MP.reset_launches()
        t0 = time.perf_counter()
        prover = ChunkProver(device=dev)
        prover.ivc.prepare_key()
        torch.cuda.synchronize()
        say("4 main", f"setup (circuit, key, bases) "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        root, proof = prover.prove(data, ci)
        dt = time.perf_counter() - t0
        n = proof.ivc_proof.num_steps
        say("4 main", f"prove chunk {ci}: {n} folds in {dt:.2f} s "
            f"({n / dt:.3f} folds/s)")
        t0 = time.perf_counter()
        require(prover.verify(proof) == root, "verify returned another root")
        say("4 main", f"verify chunk {ci}: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        root2, proofs = prover.prove_many(data, [ci, cj])
        dt = time.perf_counter() - t0
        nf = sum(p.ivc_proof.num_steps for p in proofs)
        say("4 main", f"prove_many K=2 (chunks {ci}, {cj}): {nf} folds in "
            f"{dt:.2f} s ({nf / dt:.3f} folds/s)")
        require(root2 == root, "prove_many returned another root")
        for p in proofs:
            t0 = time.perf_counter()
            require(prover.verify(p) == root, "verify returned another root")
            say("4 main", f"verify chunk {p.chunk_idx}: "
                f"{time.perf_counter() - t0:.2f} s")
        require(json.dumps(proofs[0].to_dict()) == json.dumps(
            proof.to_dict()), "prove_many proof differs from the standalone")
        say("4 main", "prove_many proof of chunk "
            f"{ci} is byte-equal to its standalone prove")

        bad = IVCProof.from_dict(proof.ivc_proof.to_dict())
        bad.comm_Ts[3] = bad.comm_Ts[4]
        tampered = type(proof)(bad, proof.chunk_idx, proof.n_blocks,
                               proof.leaf_depth, proof.total_depth)
        try:
            prover.verify(tampered)
        except AssertionError as e:
            say("4 main", f"tampered comm_T rejected ({e})")
        else:
            require(False, "a proof with a changed comm_T verified")
        torch.cuda.synchronize()
        counts = dict(MP.launches)
        want = oracle.get(timeout=900)
    require(root == want, f"root {root.hex()} != oracle {want.hex()}")
    require(native.hash_bytes(data) == want, "native hash != oracle")
    say("4 main", f"root {root.hex()} == BLAKE3 oracle (pure Python)")

    # -- 5. launches during the main path -----------------------------------
    say("5 launches", ", ".join(f"{k} {counts[k]}" for k in MAIN))
    for k in MAIN:
        require(counts[k] > 0, f"{k} was not launched on the main path")

    off_path = {"4": counts["poseidon_permute"]}

    # -- 6. the MSM bucket designs -------------------------------------------
    counts.update(designs_phase(prover, data, dev, rng, note, stats, bounds,
                                rate))

    # -- 7. the field-multiply path ------------------------------------------
    # mont_mul's count in the kernels line stays the main path's (phase 5).
    field_counts = field_phase(prover, dev, rng, note, stats, bounds)
    counts.update({k: field_counts[k] for k in FIELD if k not in MAIN})

    # -- 8. vk and segments --------------------------------------------------
    segments_phase(prover, data, ci, proof, root, dev, note)
    off_path["8"] = MP.launches["poseidon_permute"]

    # -- 9. Spartan compression ----------------------------------------------
    counts.update(compression_phase(prover, data, ci, proof, root, dev, note,
                                    stats, bounds, rate, smi))
    off_path["9"] = MP.launches["poseidon_permute"]

    # -- 10. the recursive SNARK ---------------------------------------------
    _, rp = recursive_phase(prover, data, ci, root, dev, note, rate, smi)
    off_path["10"] = MP.launches["poseidon_permute"]

    # -- 11. the compressed recursive proof -----------------------------------
    counts.update(rec_compress_phase(prover, rp, root, dev, note, stats,
                                     bounds, rate, smi))
    off_path["11"] = MP.launches["poseidon_permute"]

    # -- 12. per-step prove, checkpoints and the mesh --------------------------
    steps_mesh_phase(prover, data, ci, proof, proofs, root, dev, note, rng,
                     smi)
    off_path["12"] = MP.launches["poseidon_permute"]

    # -- 13. the batched Poseidon permutation ---------------------------------
    say("13 poseidon", "poseidon_permute launches in phases 4 and 8-12 "
        "(the kernel is on none of their paths): " + ", ".join(
            f"{k} {v}" for k, v in off_path.items()))
    require(not any(off_path.values()), "poseidon_permute ran on a path "
            "that does not call it")
    counts["poseidon_permute"] = poseidon_phase(dev, rng, note, stats,
                                                bounds, rate, smi)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": CSRC + src,
         "replaces": rep, "launches": counts[k],
         "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1],
         "library_ms": stats[k].get("library_ms"),
         **({"H": stats[k]["H"]} if "H" in stats[k] else {})}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
