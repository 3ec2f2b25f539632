"""Bucket designs for the commitment MSM, timed on the card (port of the
TPU experiments tools/exp_bucket2.py, tools/exp_tsplit.py and
tools/exp_signed_msm.py, and of tools/profile_msm_phases.py).

At the shapes the prover commits, over the real key's pre-scaled bases:

  * comm_T: m = 16,162, 256 bits, on seeded scalars below 2^254 (the
    cross term is uniform in the field): J = 1 for one chain and J = 16
    for the K = 16 lockstep chains of prove_many (listed last: the shapes
    draw their data from one seeded stream in this order);
  * the W commits: m = 15,922, 40 bits, on the prover's own W batch (the
    step witnesses of seeded chunks, full-width positions zeroed, as
    prove_many commits them): J = 16 for one K = 1 chunk of 16 steps and
    J = 256 for K = 16 lockstep chains. Witness values are mostly bits and
    u32 words, so most of their radix-16 digits are zero; each line gives
    the share that is not;

it prints the digit statistics that decide msm_bucket's and msm_merge's
work (digit_stats: the nonzero share per window, the share of (lane,
bucket) entries some digit touches, and the adds a warp of the bucket
kernel runs when it steps its lanes in lockstep against when each lane
walks its own nonzero digits), then times:

  * the production chain: digits_tm, msm_bucket, msm_merge, msm_wsum and
    the whole msm_many (digit recode included), and the whole msm_many at
    each B of PLAN_BS, held equal to plan's;
  * each design's bucket kernel alone, and whole: its own digit recode,
    the kernel, merge and wsum. The designs are msm_chain (the add chain
    with no buckets and no digits, a ceiling; its MSM is wrong by design
    and is held against its plain version instead), the t-split with H = 2
    and H = 4, and the signed digits (8 buckets, recode signed_digits_tm);
    the chain runs at ops/msm_pallas.py: chain_split's H for the shape;
  * every design's MSM equal to msm_many's as affine points;

then the host per-fold costs (a transcript absorb sequence and
fold.fold_instance). Kernel times are CUDA-event means after a warm-up.

    python -m hotproofs_tpu_torch.tools.msm_designs [--device cuda] [--seed 0]
    python -m hotproofs_tpu_torch.tools.msm_designs --stats [--device cpu]

--stats prints the digit statistics alone (no kernel runs; the CPU will
do).

The functions are importable (chip_smoke.py runs them in its phase 6).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.chunk_prover import ChunkProver
from ..nova import fold as NF
from ..nova.pedersen import CommitmentKey
from ..nova.transcript import Transcript
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm_pallas as MP
from ..utils.config import require_device

SPEC = C.PALLAS
SHAPES = {"comm_T J=1": (1, 16162, 256), "W J=16": (16, 15922, 40),
          "W J=256": (256, 15922, 40), "comm_T J=16": (16, 16162, 256)}
STEPS = 16              # steps per W commit batch of one chain
FILE_BYTES = 1 << 20    # the tool's seeded file: 1,024 chunks of 16 blocks
TSPLITS = (2, 4)
PLAN_BS = (64, 32, 16)  # B that plan could choose
REPS = 5                # timed calls per measurement, after a warm-up
WARP = 32


def timer(device: torch.device) -> Callable[[Callable, int], float]:
    """ms per call of fn over reps calls: CUDA events on the card, the
    host clock on the CPU."""
    def cuda_ms(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def host_ms(fn, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    return cuda_ms if device.type == "cuda" else host_ms


def random_scalars(rng: np.random.Generator, J: int, m: int, bits: int,
                   device) -> torch.Tensor:
    """(J, m, 32) canonical digits of seeded scalars < min(2^bits, 2^254)."""
    raw = rng.integers(0, 256, size=(J, m, 32), dtype=np.int64)
    raw[..., (bits + 7) // 8:] = 0
    raw[:, :, 31] &= 0x3F
    return torch.from_numpy(raw.astype(np.int32)).to(device)


def witness_scalars(prover: ChunkProver, data: bytes,
                    chunk_idxs: Sequence[int]) -> torch.Tensor:
    """The W batch prove_many(data, chunk_idxs) commits for its first STEPS
    folds: (K * STEPS, n_wit, 32) step witnesses, with the full-width
    positions zeroed (they take their own 256-bit MSM, pedersen.py)."""
    n_io = prover.ivc.shape.n_io
    rows = [prover._device_witness_chain(prover._hash_with_path(data, ci))[2]
            [:STEPS, 1 + n_io:] for ci in chunk_idxs]
    w = torch.cat(rows).to(prover.device)
    w[:, torch.as_tensor(prover.ivc.big_wit_idx, device=w.device)] = 0
    return w


def shape_scalars(tag: str, rng: np.random.Generator, prover: ChunkProver,
                  data: bytes) -> torch.Tensor:
    """One shape's scalars: the W batch of J / STEPS seeded chunks of data
    for the W shapes, seeded scalars for comm_T."""
    J, m, bits = SHAPES[tag]
    if tag.startswith("W"):
        chunks = rng.choice(len(data) // 1024, J // STEPS, replace=False)
        sc = witness_scalars(prover, data, [int(c) for c in chunks])
    else:
        sc = random_scalars(rng, J, m, bits, prover.device)
    assert sc.shape == (J, m, F.N_LIMBS), (tag, sc.shape)
    return sc


def nonzero_share(sc: torch.Tensor, bits: int) -> float:
    """Share of nonzero radix-16 digits in the bits // 4 windows of
    (J, m, 32) canonical scalars: the adds a bucket kernel cannot skip.
    Uniform random scalars give 15/16."""
    nib = torch.stack([sc & 15, sc >> 4], -1).reshape(*sc.shape[:2], -1)
    return float((nib[..., :bits // 4] != 0).float().mean())


def digit_stats(sc: torch.Tensor, digits: torch.Tensor,
                bits: int) -> Dict[str, object]:
    """What the digits of (J, m, 32) scalars < 2^bits ask of msm_bucket
    and msm_merge, from their (J, B, n_lanes) plan layout:

      * nonzero_per_window: the share of nonzero radix-16 digits in each
        of the bits // 4 windows;
      * touched: the share of the J * n_lanes * 15 (lane, bucket) entries
        that some digit touches (the rest are empty buckets);
      * adds_lockstep: the mean over warps of the steps at which a warp
        that steps its 32 lanes through the B steps together runs an add
        (any lane's digit nonzero); its warps are 32 consecutive (job,
        lane) threads, as in a kernel of one thread per (job, lane);
      * adds_walk: the mean over warps of the most nonzero digits of any
        of its lanes, the adds of a warp whose lanes each walk their own
        nonzero digits; its warps are 32 consecutive lanes of one job, as
        in msm_bucket's blocks."""
    J, B, L = digits.shape
    nib = MP.digits4(sc, MP.n_windows4(bits))[:, :bits // 4]
    nz = digits != 0
    touched = sum(int((digits == v).any(dim=1).sum())
                  for v in range(1, MP.NBUCKET + 1))
    flat = nz.permute(1, 0, 2).reshape(B, J * L)
    flat = torch.nn.functional.pad(flat, (0, -(J * L) % WARP))
    lockstep = flat.reshape(B, -1, WARP).any(dim=2).sum(dim=0)
    per_lane = torch.nn.functional.pad(nz.sum(dim=1), (0, -L % WARP))
    walk = per_lane.reshape(J, -1, WARP).amax(dim=2)
    return {"nonzero_per_window": (nib != 0).double().mean(dim=(0, 2))
            .tolist(),
            "touched": touched / (J * L * MP.NBUCKET),
            "adds_lockstep": float(lockstep.double().mean()),
            "adds_walk": float(walk.double().mean())}


def recode(name: str, sc: torch.Tensor, bits: int) -> torch.Tensor:
    """A design's digits of (J, m, 32) scalars < 2^bits: signed ones for
    "signed" (one window more, MP.signed_bits), radix-16 for the others."""
    m = sc.shape[1]
    if name == "signed":
        b, lpw, w4, _ = MP.plan(m, MP.signed_bits(bits))
        return MP.signed_digits_tm(sc, m, b, lpw, w4)
    b, lpw, w4, _ = MP.plan(m, bits)
    return MP.digits_tm(sc, m, b, lpw, w4)


class Inputs(NamedTuple):
    """One shape's scalars and both digit and base layouts."""

    J: int
    m: int
    bits: int
    scalars: torch.Tensor
    digits: torch.Tensor       # (J, B, n_lanes) radix-16
    bases: torch.Tensor        # (B, 2, 8, n_lanes)
    bases_lm: torch.Tensor     # its lane-major copy, which the walks read
    sdigits: torch.Tensor      # signed, plan(m, signed_bits(bits))
    sbases: torch.Tensor
    sbases_lm: torch.Tensor
    plan_bases: Dict[int, tuple]   # B -> the bases for B and their copy


def prepare(key: CommitmentKey, sc: torch.Tensor, bits: int) -> Inputs:
    """(J, m, 32) canonical scalars < 2^bits and the key's first m
    generators -> both digit layouts and their bases."""
    J, m = sc.shape[:2]
    wide = {}
    for b in PLAN_BS:
        tm = MP.bases_tm(*key.scaled_affine(m, bits), m, bits, b)
        wide[b] = (tm, MP.lane_major(tm))
    return Inputs(J, m, bits, sc, recode("bucket", sc, bits),
                  key.bases(m, bits), key.bases_lm(m, bits),
                  recode("signed", sc, bits),
                  key.bases(m, MP.signed_bits(bits)),
                  key.bases_lm(m, MP.signed_bits(bits)), wide)


DESIGNS = ("bucket", "chain") + tuple(f"tsplit H={h}" for h in TSPLITS) \
    + ("signed",)


def bucket_stage(name: str, inp: Inputs,
                 digits: Optional[torch.Tensor]) -> torch.Tensor:
    """The design's bucket kernel on its digits (the chain reads none):
    (J, S, 3, 8, lanes) for K2."""
    if name == "bucket":
        return MP.msm_bucket(SPEC, digits, inp.bases, inp.bases_lm)
    if name == "chain":
        return MP.msm_chain(SPEC, inp.bases, inp.J)[:, None]
    if name.startswith("tsplit H="):
        H = int(name.split("=")[1])
        return MP.msm_bucket_tsplit(SPEC, digits, inp.bases, H,
                                    inp.bases_lm)
    if name == "signed":
        return MP.msm_bucket_signed(SPEC, digits, inp.sbases, inp.sbases_lm)
    raise ValueError(f"unknown design {name!r}")


def design_msm(name: str, inp: Inputs) -> torch.Tensor:
    """The whole design: its recode -> bucket kernel -> msm_merge ->
    msm_wsum: (J, 3, 8)."""
    digits = None if name == "chain" else recode(name, inp.scalars, inp.bits)
    bk = bucket_stage(name, inp, digits)
    return MP.msm_wsum(SPEC, MP.msm_merge(SPEC, bk.contiguous()))


def affine_words(s: torch.Tensor) -> list:
    """(J, 3, 8) projective Montgomery words -> J affine int pairs."""
    d = F.words_to_digits(s)
    return C.pt_to_affine_host(SPEC, (d[:, 0], d[:, 1], d[:, 2]))


def measure(inp: Inputs, reps: int) -> Dict[str, object]:
    """Times (ms) and checks of one shape: the production stages, then per
    design its bucket kernel alone and whole."""
    ms = timer(inp.digits.device)
    b, _, _, n_lanes = MP.plan(inp.m, inp.bits)
    bk = MP.msm_bucket(SPEC, inp.digits, inp.bases, inp.bases_lm)
    red = MP.msm_merge(SPEC, bk)
    whole = lambda: MP.msm_many(SPEC, inp.scalars, inp.bases, inp.m,
                                inp.bits, bases_lm=inp.bases_lm)
    want = C.pt_to_affine_host(SPEC, whole())
    out: Dict[str, object] = {
        "J": inp.J, "m": inp.m, "bits": inp.bits, "B": b,
        "n_lanes": n_lanes,
        "nonzero_digits": nonzero_share(inp.scalars, inp.bits),
        "digit_stats": digit_stats(inp.scalars, inp.digits, inp.bits),
        "digits_tm": ms(lambda: recode("bucket", inp.scalars, inp.bits),
                        reps),
        "signed_digits_tm": ms(lambda: recode("signed", inp.scalars,
                                              inp.bits), reps),
        "msm_bucket": ms(lambda: MP.msm_bucket(SPEC, inp.digits, inp.bases,
                                               inp.bases_lm), reps),
        "msm_merge": ms(lambda: MP.msm_merge(SPEC, bk), reps),
        "msm_wsum": ms(lambda: MP.msm_wsum(SPEC, red), reps),
        "msm_many": ms(whole, reps),
        "plan_b": {},
        "designs": {},
    }
    for pb, (tm, lm) in inp.plan_bases.items():
        many = lambda: MP.msm_many(SPEC, inp.scalars, tm, inp.m, inp.bits,
                                   pb, lm)
        ok = C.pt_to_affine_host(SPEC, many()) == want     # and a warm-up
        out["plan_b"][pb] = {"ms": ms(many, reps), "ok": ok}
    for name in DESIGNS:
        digits = inp.sdigits if name == "signed" else inp.digits
        if name == "chain":
            plain = MP.msm_chain_plain(SPEC, inp.bases, inp.J)
            ok = torch.equal(bucket_stage(name, inp, None)[:, 0].cpu(),
                             plain.cpu())
        else:
            ok = affine_words(design_msm(name, inp)) == want
        out["designs"][name] = {
            "kernel_ms": ms(lambda: bucket_stage(name, inp, digits), reps),
            "ms": ms(lambda: design_msm(name, inp), reps),
            "check": "== plain" if name == "chain" else "== msm_many",
            "ok": bool(ok),
        }
        if name == "chain":
            out["designs"][name]["H"] = MP.chain_split(inp.J, n_lanes, b)
    return out


def host_fold_costs(rng: np.random.Generator, nrep: int = 20
                    ) -> Dict[str, float]:
    """Host ms per fold: the transcript's absorb sequence and challenge,
    and the instance fold (tools/profile_msm_phases.py:172-204)."""
    tr = Transcript(SPEC.scalar.name, b"profile", 12345)
    pt = SPEC.gen
    X = [int(v) for v in rng.integers(1 << 30, size=30)]
    t0 = time.perf_counter()
    for _ in range(nrep):
        tr.absorb_scalar(7)
        for v in X:
            tr.absorb_scalar(v)
        tr.absorb_point(pt)
        tr.absorb_point(pt)
        for v in X:
            tr.absorb_scalar(v)
        tr.absorb_point(pt)
        tr.absorb_point(pt)
        r = tr.challenge()
    transcript = (time.perf_counter() - t0) * 1e3 / nrep
    acc = NF.AccumulatorInstance(u=0, X=[0] * 30)
    f = SPEC.scalar
    t0 = time.perf_counter()
    for i in range(nrep):
        acc = NF.fold_instance(f, SPEC, acc, X, pt, pt, (r + i) % f.p)
    return {"host_transcript_fold_ms": transcript,
            "host_fold_instance_ms": (time.perf_counter() - t0) * 1e3 / nrep}


def stats_line(tag: str, st: Dict[str, object]) -> str:
    return (f"{tag} digits: nonzero per window [" + ", ".join(
        f"{v:.4f}" for v in st["nonzero_per_window"]) + "], touched "
        f"(lane, bucket) {st['touched']:.4f}, adds per warp lockstep "
        f"{st['adds_lockstep']:.2f} / sorted walk {st['adds_walk']:.2f}")


def report(tag: str, res: Dict[str, object]) -> list:
    """One line for the production stages, one per design ("whole": its
    recode, if it reads digits, + kernel + merge + wsum)."""
    lines = [f"{tag} (m={res['m']}, {res['bits']} bits, B={res['B']}, "
             f"{res['n_lanes']} lanes, nonzero digits "
             f"{res['nonzero_digits']:.4f}): digits_tm "
             f"{res['digits_tm']:.3f} ms, msm_bucket {res['msm_bucket']:.3f}, "
             f"msm_merge {res['msm_merge']:.3f}, msm_wsum "
             f"{res['msm_wsum']:.3f}, whole msm_many {res['msm_many']:.3f}; "
             f"signed_digits_tm {res['signed_digits_tm']:.3f}",
             stats_line(tag, res["digit_stats"])]
    if res["plan_b"]:
        lines.append(f"{tag} whole msm_many by B: " + ", ".join(
            f"B={b} {d['ms']:.3f} ms {'OK' if d['ok'] else 'FAILED'}"
            for b, d in res["plan_b"].items()))
    for name, d in res["designs"].items():
        if "H" in d:
            name = f"{name} H={d['H']}"
        lines.append(f"{tag} {name}: kernel {d['kernel_ms']:.3f} ms, whole "
                     f"{d['ms']:.3f} ms, {d['check']} "
                     f"{'OK' if d['ok'] else 'FAILED'}")
    return lines


def run(prover: ChunkProver, data: bytes, rng: np.random.Generator,
        reps: int = REPS, out=print) -> Dict[str, object]:
    """measure() at every shape of SHAPES on prover's key, each shape's
    report lines passed to out; then the host per-fold costs."""
    results = {}
    for tag, (_, _, bits) in SHAPES.items():
        res = measure(prepare(prover.ivc.ck, shape_scalars(
            tag, rng, prover, data), bits), reps)
        for line in report(tag, res):
            out(line)
        results[tag] = res
        if prover.device.type == "cuda":
            torch.cuda.empty_cache()
    results["host"] = host_fold_costs(rng)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: %(default)s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats", action="store_true",
                    help="print the digit statistics alone")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {dev}: {name}", flush=True)
    rng = np.random.default_rng(args.seed)
    prover = ChunkProver(device=dev)
    data = rng.bytes(FILE_BYTES)
    if args.stats:
        for tag, (_, m, bits) in SHAPES.items():
            sc = shape_scalars(tag, rng, prover, data)
            b, lpw, w4, _ = MP.plan(m, bits)
            print(stats_line(tag, digit_stats(
                sc, MP.digits_tm(sc, m, b, lpw, w4), bits)), flush=True)
        return 0
    results = run(prover, data, rng,
                  out=lambda line: print(line, flush=True))
    print(json.dumps(results))
    return 0 if all_ok(results) else 1


def all_ok(results: Dict[str, object]) -> bool:
    """Every design's and every plan B's MSM agreed."""
    return all(d["ok"] for tag in SHAPES
               for part in ("designs", "plan_b")
               for d in results[tag][part].values())


if __name__ == "__main__":
    raise SystemExit(main())
