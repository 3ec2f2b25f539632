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
     the launch counts of that run (every one must be > 0).
The last two lines are the kernels' JSON summary (with each kernel's
bound: the least time the card could take for the work of its timed
call) and the result line.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

import numpy as np
import torch

FILE_BYTES = 64 << 20   # 65,536 chunks: a chunk proof is 16 blocks + 16 levels
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
}
MAIN = ("msm_bucket", "msm_merge", "msm_wsum", "to_affine",
        "mont_mul")                                            # phase 4
DESIGNS = ("msm_chain", "msm_bucket_tsplit", "msm_bucket_signed")  # phase 6
FIELD = ("mont_mul", "mont_mul_stage", "mont_mul_part", "conv_mma")  # phase 7

# The bound of a kernel's call: the larger of its bytes (each input read
# once, each output written once) over the HBM rate and its 32-bit integer
# multiplies over the card's multiply rate. A CIOS Montgomery product on
# 8 words takes 2 x (64 + 64) multiplies for its 32 x 32 -> 64 products
# (low and high halves) plus 8 for the reduction factors. An RCB15 mixed
# add needs 11 full products and a complete add 12 (csrc/curve.cuh does 2
# more, by the constant 3b = 15, which a few modular additions can do);
# to_affine needs 5 products a point (Montgomery's batch inversion, 3,
# then x and y) plus one Fermat inversion for the batch. The rate is the
# CUDA C++ Programming Guide's throughput of 32-bit integer multiply(-add)
# for compute capability 9.0, 64 per clock per SM, at the SM's maximum
# clock that nvidia-smi reports; the memory rate is the H100 SXM's
# 3.35 TB/s.
MUL32_PER_MONT = 2 * (64 + 64) + 8
MONT_MIXED_ADD, MONT_ADD = 11, 12
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
