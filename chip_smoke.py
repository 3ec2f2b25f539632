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
  6. the MSM bucket designs (tools/msm_designs.py): msm_chain,
     msm_bucket_tsplit, msm_bucket_signed and the 8-slot merge and wsum
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
     stage and part with its time, its plain version's and its bound, and
     the launch counts of that run (every one must be > 0);
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
     msm_merge, msm_wsum and mont_mul must be > 0); last, msm_bucket,
     msm_merge, msm_wsum and mont_mul against their plain versions on the
     inputs of the first MSM and to_mont call of each shape, scalars not
     all zero, that the segment runs gave them (exact equality);
  9. Spartan compression (nova/spartan.py), with the launch counts set to
     0 before it: the phase-4 prover's SpartanSystem set up (its matrix
     tables built on the host or loaded from the disk cache, then laid out
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
     setup gave it, timed beside its bound, and each round of the first
     IPA (its J = 2 commit over the key's prepared bases beside the MSM's
     bound, and its two mont_mul) timed on the scalars the compress gave
     it, with the card's name and power limit beside every time.
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
}
MAIN = ("msm_bucket", "msm_merge", "msm_wsum", "to_affine",
        "mont_mul")                                            # phase 4
DESIGNS = ("msm_chain", "msm_bucket_tsplit", "msm_bucket_signed")  # phase 6
FIELD = ("mont_mul", "mont_mul_stage", "mont_mul_part", "conv_mma")  # phase 7
COMPRESS = ("msm_bucket", "msm_merge", "msm_wsum", "to_affine", "mont_mul",
            "scale16")                                         # phase 9
# Phase 9's fixtures: the reference's IVC and compressed proofs of two toy
# chains (tests/data, made by the JAX package on the CPU), whose circuits
# and stack tests/spartan_chains.py holds.
TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
SPARTAN_CHAINS = ("toy", "wide")

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
        after a warm-up; plain: one run), record the times of msm_chain,
        the H = 2 t-split and the signed kernel there, and return all
        times by label."""
        sd = MP.msm_bucket_signed(spec, inp.sdigits, inp.sbases)
        red = MP.msm_merge(spec, sd)
        runs = {
            "msm_chain": (
                lambda: MP.msm_chain(spec, inp.bases, inp.J),
                lambda: MP.msm_chain_plain(spec, inp.bases, inp.J)),
            **{f"msm_bucket_tsplit H={h}": (
                lambda h=h: MP.msm_bucket_tsplit(spec, inp.digits,
                                                 inp.bases, h),
                lambda h=h: MP.msm_bucket_tsplit_plain(spec, inp.digits,
                                                       inp.bases, h))
               for h in D.TSPLITS},
            "msm_bucket_signed": (
                lambda: MP.msm_bucket_signed(spec, inp.sdigits, inp.sbases),
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
            for label in ("msm_chain", "msm_bucket_tsplit H=2",
                          "msm_bucket_signed"):
                name = label.split()[0]
                stats_out[name]["ms"], stats_out[name]["plain_ms"] = \
                    times[label]
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
        say("6 designs", f"seeded {bits} bits (J=3, m={m}): msm_chain, "
            "msm_bucket_tsplit (H=2, 4), msm_bucket_signed, merge and wsum "
            "(S=8) == plain")
    J, m, bits = D.SHAPES["comm_T J=1"]
    inp = D.prepare(ck, D.random_scalars(rng, J, m, bits, dev), bits)
    times = design_check(inp, stats)
    live = int((inp.digits != 0).sum())
    slive = int(((inp.sdigits & 15) != 0).sum())
    B, L = inp.digits.shape[1:]
    SL = inp.sdigits.shape[-1]
    pt = 3 * 8 * 4                                  # bytes of a point
    signed_out = J * MP.NSIGNED * pt * SL
    label_bounds = {
        "msm_chain": bound(MONT_MIXED_ADD * J * B * L,
                           nbytes(inp.bases) + J * pt * L, rate),
        **{f"msm_bucket_tsplit H={h}": bound(
            MONT_MIXED_ADD * live, nbytes(inp.digits, inp.bases)
            + J * MP.NBUCKET * pt * h * L, rate) for h in D.TSPLITS},
        "msm_bucket_signed": bound(MONT_MIXED_ADD * slive,
                                   nbytes(inp.sdigits, inp.sbases)
                                   + signed_out, rate),
        "msm_merge S=8": merge_bound(
            MP.msm_bucket_signed(spec, inp.sdigits, inp.sbases),
            torch.empty(J, MP.NSIGNED, 3, 8, dtype=torch.int32), rate)[:2],
        "msm_wsum S=8": bound(MONT_ADD * J * 2 * MP.NSIGNED,
                              J * MP.NSIGNED * pt + J * pt, rate),
    }
    say("6 times", "comm_T J=1: " + ", ".join(
        f"{k} {v[0]:.3f} ms (plain {v[1]:.1f} ms, bound "
        f"{label_bounds[k][0]:.4f} ms by {label_bounds[k][1]})"
        for k, v in times.items()))
    for label in ("msm_chain", "msm_bucket_tsplit H=2", "msm_bucket_signed"):
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
    to_mont call of each shape not seen before whose scalars are not all
    zero (a chain's first cross term is), keyed by (kind, shape), with the
    label of the run that gave them: phase 8 holds the kernels against
    their plain versions on them."""
    from hotproofs_tpu_torch.ops import field as F
    from hotproofs_tpu_torch.ops import msm_pallas as MP

    msm_many, to_mont = MP.msm_many, F.to_mont

    def msm_rec(spec, scalars, bases, m, max_bits, b=None, bases_lm=None):
        key = ("msm", (scalars.shape[0], m, max_bits))
        if key not in seen and bool(scalars.any()):
            seen[key] = (label, spec, scalars.clone(), bases, m, max_bits,
                         b, bases_lm)
        return msm_many(spec, scalars, bases, m, max_bits, b, bases_lm)

    def mont_rec(spec, a):
        key = ("to_mont", tuple(a.shape))
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

    for (kind, dims), (label, *inp) in seen.items():
        t0 = time.perf_counter()
        if kind == "to_mont":
            spec, x = inp
            note("mont_mul", PF.mont_mul_em(spec, x, PF.const_digits(
                spec, "r2", dev)), PF.mont_mul_em_plain(
                spec, x, PF.const_digits(spec, "r2", dev)))
            what = f"mont_mul (to_mont of {' x '.join(map(str, dims[:2]))})"
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
            what = f"msm_bucket, msm_merge, msm_wsum (J={dims[0]}, " \
                f"m={m}, {bits} bits, nonzero digits " \
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
    from hotproofs_tpu_torch.ops import msm_pallas as MP
    from hotproofs_tpu_torch.utils import telemetry as T_
    from hotproofs_tpu_torch.utils.config import CONFIG

    if TESTS_DIR not in sys.path:
        sys.path.append(TESTS_DIR)
    from spartan_chains import load_ref, port_stack

    tag = "9 compress"
    counter = lambda k: T_.metrics.snapshot().get(k, 0)
    spec = prover.ivc.curve
    ck = prover.ivc.ck
    seen: dict = {}
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # Setup: the tables of the blake3 circuit, from the disk cache when an
    # earlier run left them, then on the card with the key's bases at the
    # IPAs' lengths.
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
    how = "built on the host" if counter("spartan/h_builds") > builds \
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
    for k in ("scale16", "to_affine"):
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
        "launched no scale16 and no to_affine")

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
        ms = cuda_ms(lambda: MP.scale16(sspec, pts, windows), 5)
        # The identity (Z = 0) needs no work: only the other points count.
        live = int((pts[:, 2] != 0).any(-1).sum())
        steps = windows - 1
        bnd = bound(live * steps * (4 * MONT_DOUBLE + MONT_TO_HOMOGENEOUS),
                    nbytes(pts, got), rate)
        say(tag, f"scale16 == plain (projective and affine) on {what}, "
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
    say("7 launches", ", ".join(f"{k} {counts[k]}" for k in FIELD))
    for k in FIELD:
        require(counts[k] > 0, f"{k} was not launched on the field-multiply "
                "path")
    return counts


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

    # -- 6. the MSM bucket designs -------------------------------------------
    counts.update(designs_phase(prover, data, dev, rng, note, stats, bounds,
                                rate))

    # -- 7. the field-multiply path ------------------------------------------
    # mont_mul's count in the kernels line stays the main path's (phase 5).
    field_counts = field_phase(prover, dev, rng, note, stats, bounds)
    counts.update({k: field_counts[k] for k in FIELD if k not in MAIN})

    # -- 8. vk and segments --------------------------------------------------
    segments_phase(prover, data, ci, proof, root, dev, note)

    # -- 9. Spartan compression ----------------------------------------------
    counts.update(compression_phase(prover, data, ci, proof, root, dev, note,
                                    stats, bounds, rate, smi))

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": CSRC + src,
         "replaces": rep, "launches": counts[k],
         "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": None}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
