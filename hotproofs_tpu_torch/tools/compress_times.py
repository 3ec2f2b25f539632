"""Spartan compression of one chunk proof, timed on the card.

    python -m hotproofs_tpu_torch.tools.compress_times [--device cuda]
        [--seed 0] [--reps 3] [--out F]

Proves one chunk of a 64 MiB file made from --seed (16 block folds and 16
Merkle-level folds: 32 folds, the full-width blake3 circuit), compresses
and verifies the proof once to set up (the key's bases prepared, the
matrix tables built or loaded and laid out), then times --reps warm
`compress` calls with the seconds
of each part (sum-check 1, sum-check 2, the IPAs of L, W and E), and
--reps `verify_compressed` calls. Host clock around calls that end in a
read-back to the host. It prints each call's line, the kernels' launches
in one warm compress and its verify, the sha256 of the compressed proof's
file (which every call must reproduce), and a JSON line last. One more
warm compress runs under torch.profiler: the card's busy time (the device
events' summed self time), the profiled wall time and the kernels that
took the most of it. Last, the host's time for one of the scalar
multiplications by U_c that each IPA round makes two of (ops/curve.py
host_scalar_mul, mean of 20 on seeded scalars).

It reaches the prover only through ChunkProver's public calls and the
SpartanSystem's timings, so the same file times an older tree.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..models.chunk_prover import ChunkProver
from ..ops import curve as C
from ..ops import msm_pallas as MP
from ..utils.config import require_device

FILE_BYTES = 64 << 20
CHUNK_BYTES = 1024


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _file_sha256(cp) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cp.json")
        cp.save(path)
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()


def run(dev, seed: int, reps: int, out=print) -> dict:
    rng = np.random.default_rng(seed)
    data = rng.bytes(FILE_BYTES)
    ci = int(rng.integers(FILE_BYTES // CHUNK_BYTES))
    prover = ChunkProver(device=dev)
    root, proof = prover.prove(data, ci)
    folds = proof.ivc_proof.num_steps
    sps = prover.spartan

    t0 = time.perf_counter()
    first = prover.compress(proof)
    _sync(dev)
    t1 = time.perf_counter()
    if prover.verify_compressed(first, root) != root:
        raise SystemExit("compress_times: verify_compressed failed")
    _sync(dev)
    res = {"chunk": ci, "folds": folds, "first_compress_s": t1 - t0,
           "first_parts_s": dict(sps.timings),
           "first_verify_s": time.perf_counter() - t1, "compress": [],
           "verify_s": []}
    sha = _file_sha256(first)
    out(f"chunk {ci} ({folds} folds): first compress "
        f"{res['first_compress_s']:.3f} s, first verify_compressed "
        f"{res['first_verify_s']:.3f} s (setup included), sha256 {sha}")
    for k in range(reps):
        before = dict(MP.launches)
        t0 = time.perf_counter()
        cp = prover.compress(proof)
        _sync(dev)
        dt = time.perf_counter() - t0
        res["compress"].append({"s": dt, "parts_s": dict(sps.timings)})
        if _file_sha256(cp) != sha:
            raise SystemExit("compress_times: a compress gave other bytes")
        out(f"compress {k + 1}: {dt:.3f} s; " + ", ".join(
            f"{p} {v:.3f} s" for p, v in sps.timings.items()))
        t0 = time.perf_counter()
        if prover.verify_compressed(cp, root) != root:
            raise SystemExit("compress_times: verify_compressed failed")
        _sync(dev)
        res["verify_s"].append(time.perf_counter() - t0)
        out(f"verify_compressed {k + 1}: {res['verify_s'][-1]:.3f} s")
        if k == 0:
            res["launches"] = {n: MP.launches[n] - before[n]
                               for n in MP.launches
                               if MP.launches[n] != before[n]}
            out("launches in one warm compress and its verify: " + ", ".join(
                f"{n} {c}" for n, c in res["launches"].items()))
    res["profile"] = _profile(prover, proof, dev, out)
    ipa = sps.ipa
    ks = [int.from_bytes(rng.bytes(32), "little") for _ in range(20)]
    t0 = time.perf_counter()
    for k in ks:
        C.host_scalar_mul(ipa.curve, k, ipa.U_affine)
    res["host_scalar_mul_ms"] = (time.perf_counter() - t0) / len(ks) * 1e3
    out(f"host scalar multiplication by U_c: "
        f"{res['host_scalar_mul_ms']:.2f} ms (mean of {len(ks)}; two an IPA "
        "round)")
    res["sha256"] = sha
    return res


def _profile(prover, proof, dev, out) -> dict:
    """One warm compress under torch.profiler: device busy ms (the summed
    self time of the device's events: kernels and copies, as the
    profiler's table totals it), the profiled wall ms and the top device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prover.compress(proof)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: e.self_device_time_total
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA), key=dev_us,
                    reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3
    top = [{"name": e.key, "ms": dev_us(e) / 1e3, "calls": e.count}
           for e in events[:12] if dev_us(e) > 0]
    out(f"profiled compress: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1 - busy / wall:.3f}); top: " + ", ".join(
            f"{t['name'][:40]} {t['ms']:.1f} ms / {t['calls']}"
            for t in top))
    return {"wall_ms": wall, "busy_ms": busy, "top": top}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: %(default)s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {dev}: {name}", flush=True)
    res = run(dev, args.seed, args.reps,
              out=lambda line: print(line, flush=True))
    res["device"] = name
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
