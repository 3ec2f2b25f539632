"""On-card smoke test of the PyTorch/CUDA port (hotproofs_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, one or more lines each; any failure ends the run with a non-zero
exit and no result line:
  1. the card (nvidia-smi name and power limit) and the toolchain;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and time the build;
  3. each kernel against its plain torch version on the card, on seeded
     inputs (exact integer equality), then kernel and plain times at the
     main path's shapes;
  4. the main path at full circuit size: ChunkProver(device="cuda") proves
     one chunk of a 64 MiB file (depth 16), verifies it against the BLAKE3
     oracle's root, proves two chunks in lockstep (prove_many), verifies
     both, and rejects a proof with one comm_T changed;
  5. each kernel's launch count during phase 4 (every one must be > 0).
The last two lines are the kernels' JSON summary and the result line.
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
SOURCE = "hotproofs_tpu_torch/csrc/msm.cu"
REPLACES = {
    "msm_bucket": "hotproofs_tpu/ops/msm_pallas.py:210",
    "msm_merge": "hotproofs_tpu/ops/msm_pallas.py:288",
    "msm_wsum": "hotproofs_tpu/ops/msm_pallas.py:358",
    "to_affine": "hotproofs_tpu/ops/msm_pallas.py:66",
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    """Fail the run (exit code 1, no result line) unless cond."""
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _oracle_root(data: bytes) -> bytes:
    from hotproofs_tpu.core import blake3_ref
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


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape, f"shapes {a.shape} != {b.shape}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2

    from hotproofs_tpu.core import native
    from hotproofs_tpu_torch.models.chunk_prover import ChunkProver
    from hotproofs_tpu_torch.nova.ivc import IVCProof
    from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
    from hotproofs_tpu_torch.ops import cuda_lib
    from hotproofs_tpu_torch.ops import curve as C
    from hotproofs_tpu_torch.ops import field as F
    from hotproofs_tpu_torch.ops import msm_pallas as MP
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

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.lib()
    say("2 build", f"kernels loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_lib.build_info.get('seconds', 0.0):.1f} s) "
        f"from {os.path.relpath(cuda_lib.build_info['path'])}")
    for line in cuda_lib.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "stack frame" in line or \
                "Compiling entry" in line:
            say("2 build", "ptxas: " + line.strip())

    # -- 3. kernels vs plain versions on the card -----------------------------
    stats = {k: {"max_abs_err": 0} for k in REPLACES}
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

    # to_affine on 4,096 projective points (64 generators x 64 windows).
    pts = tuple(c[:64] for c in tmp_key.points)
    X, Y, Z = (F.digits_to_words(c.reshape(-1, 32))
               for c in MP.scale_points16(spec, pts, 64))
    Z[5] = 0                                  # 0 -> (0, 0) must agree too
    xk, yk = MP.to_affine_words(spec, X, Y, Z)
    xp, yp = MP.to_affine_words_plain(spec, X, Y, Z)
    torch.cuda.synchronize()
    note("to_affine", xk, xp)
    note("to_affine", yk, yp)
    say("3 kernels", f"to_affine == plain on {X.shape[0]} points")

    def chain_check(scalars, bases, m, bits, tag):
        b, lpw, w4, n_lanes = MP.plan(m, bits)
        d = MP.digits_tm(scalars, m, b, lpw, w4)
        bk = MP.msm_bucket(spec, d, bases)
        note("msm_bucket", bk, MP.msm_bucket_plain(spec, d, bases))
        red = MP.msm_merge(spec, bk)
        note("msm_merge", red, MP.msm_merge_plain(spec, bk))
        s = MP.msm_wsum(spec, red)
        note("msm_wsum", s, MP.msm_wsum_plain(spec, red))
        torch.cuda.synchronize()
        say("3 kernels", f"{tag}: bucket, merge, wsum == plain "
            f"(J={scalars.shape[0]}, m={m}, {bits} bits, B={b}, "
            f"{n_lanes} lanes)")
        return d, bk, red

    m = 1000
    for bits in (40, 256):
        raw = rng.integers(0, 256, size=(3, m, 32), dtype=np.int64)
        raw[..., (bits + 7) // 8:] = 0
        raw[:, :, 31] &= 0x3F                       # < 2^254 < group order
        raw[1] = 0                                  # all-zero job
        sc = torch.from_numpy(raw.astype(np.int32)).to(dev)
        chain_check(sc, tmp_key.bases(m, bits), m, bits, f"seeded {bits}")
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
    say("3 times", f"to_affine on {P3[0].shape[0]} points: {ms:.3f} ms "
        f"(plain {plain:.1f} ms)")
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
        bases = tmp_key.bases(mm, bits)
        d, bk, red = chain_check(sc, bases, mm, bits, tag)
        times = {}
        for name, kern, plain in (
                ("msm_bucket", lambda: MP.msm_bucket(spec, d, bases),
                 lambda: MP.msm_bucket_plain(spec, d, bases)),
                ("msm_merge", lambda: MP.msm_merge(spec, bk),
                 lambda: MP.msm_merge_plain(spec, bk)),
                ("msm_wsum", lambda: MP.msm_wsum(spec, red),
                 lambda: MP.msm_wsum_plain(spec, red))):
            kern()
            times[name] = (cuda_ms(kern, 5), cuda_ms(plain, 1))
            if tag == "comm_T J=1":
                stats[name]["ms"], stats[name]["plain_ms"] = times[name]
        chain = cuda_ms(lambda: MP.msm_many(spec, sc, bases, mm, bits), 5)
        say("3 times", f"{tag}: " + ", ".join(
            f"{k} {v[0]:.3f} ms (plain {v[1]:.1f} ms)"
            for k, v in times.items()) + f"; whole msm_many {chain:.3f} ms")
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
    say("5 launches", ", ".join(f"{k} {v}" for k, v in counts.items()))
    for k, v in counts.items():
        require(v > 0, f"{k} was not launched on the main path")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": counts[k],
         "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"]} for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
