"""One long chain on the card: a single BLAKE3 Nova chain of >= 4,096 steps
proved as segments in lockstep waves, killed mid-run, resumed and verified
(port of tools/longchain_deep.py).

The statement is a deep-tree membership claim: one chunk (16 block steps)
and `steps - 16` parent steps (core/blake3_ref.synthetic_deep_path_proof),
on the step circuit widened to depth_bits=13 (ChunkProver(depth_bits=13),
the `blake3-chunk-d13` circuit). The witness is generated on the card in
slices of 512 steps and kept in host memory (a 4,096-step chain's digits
are about 8.4 GB); the fold uploads one chunk of steps at a time. The chain
is split into `--segments` segments proved in lockstep waves of `--group`
(parallel/segments.prove_segments), checkpointed wave by wave, composed by
public-IO chaining and verified end to end.

Kill and resume (default mode): the orchestrator runs the prover as a child
process, SIGKILLs it as soon as the first wave's checkpoints are on disk,
then runs it again; the second run resumes those segments and proves the
rest. It prints one JSON line last (wall time, folds/s a wave, resumed and
proved counts, verify time, peak device and host memory), and writes it
to `--out` only when asked.

    python -m hotproofs_tpu_torch.tools.longchain_deep [--steps 4096]
        [--segments 32] [--group 8] [--ckpt DIR] [--out FILE]
        [--device cuda]

The functions are importable (chip_smoke.py drives a shorter chain with
them, stopping in-process after the first wave).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import signal
import subprocess
import sys
import time

import torch

from ..core import blake3_ref as b3
from ..parallel.segments import (prove_segments, split_plan,
                                 verify_segments)
from ..utils import telemetry as T
from ..utils.config import CONFIG

DEPTH_BITS = 13
SEED = 2026


def deep_chain(prover, n_steps: int, seed: int = SEED) -> dict:
    """The chain's statement and host witness: 16 block steps of one chunk
    and n_steps - 16 synthetic parent levels."""
    pd = b3.synthetic_deep_path_proof(bytes(range(256)) * 4, n_steps - 16,
                                      seed=seed)
    t0 = time.perf_counter()
    zs, sched, canon, X_host = prover._host_witness_chain(pd)
    if len(sched.steps) != n_steps:
        raise RuntimeError(f"{len(sched.steps)} steps, want {n_steps}")
    return {"pd": pd, "zs": zs, "sched": sched, "canon": canon,
            "X_host": X_host, "witness_s": time.perf_counter() - t0}


class _Stopped(Exception):
    pass


def prove(prover, chain: dict, segments: int, group: int, ckpt: str,
          stop_after: int = 0, progress: bool = False) -> dict:
    """prove_segments over the chain in lockstep waves, checkpointed in
    ckpt. stop_after > 0 stops the run after that many waves (what a kill
    leaves on disk). Returns the segmented proof (None when stopped), the
    counts of this call and each wave's segments, folds and seconds (the
    `segments/lockstep_wave` span's)."""
    bounds = split_plan(len(chain["X_host"]), segments)
    waves = []

    def on_wave(ks, s):
        w = {"segments": len(ks),
             "folds": sum(bounds[k][1] - bounds[k][0] for k in ks), "s": s}
        w["folds_per_s"] = w["folds"] / s
        waves.append(w)
        if progress:
            print(f"wave: {w['segments']} segments, {w['folds']} folds in "
                  f"{s:.2f} s ({w['folds_per_s']:.3f} folds/s)",
                  file=sys.stderr, flush=True)
        if len(waves) == stop_after:
            raise _Stopped

    before = T.metrics.snapshot()
    t0 = time.perf_counter()
    try:
        seg = prove_segments(prover.ivc, chain["zs"], chain["canon"],
                             chain["X_host"], n_segments=segments,
                             lockstep=True, lockstep_group=group,
                             checkpoint_dir=ckpt, on_wave=on_wave,
                             progress=progress)
    except _Stopped:
        seg = None
    after = T.metrics.snapshot()
    delta = {k: int(after.get(f"segments/{k}", 0)
                    - before.get(f"segments/{k}", 0))
             for k in ("proved", "resumed")}
    return {"proof": seg, "waves": waves, "wall_s": time.perf_counter() - t0,
            **delta}


def verify(prover, chain: dict, seg) -> float:
    """Verify the composed proof and its statement (z0, the published
    root, depth 0); returns the seconds it took."""
    t0 = time.perf_counter()
    z_fin = verify_segments(prover.ivc, seg,
                            io_arity=len(chain["zs"][0]))
    p = prover.modulus
    if [v % p for v in seg.z0] != [v % p for v in chain["sched"].z0]:
        raise AssertionError("z0 binding")
    root = chain["pd"].root_hash
    if z_fin[2:10] != [int.from_bytes(root[4 * i: 4 * i + 4], "little")
                       for i in range(8)]:
        raise AssertionError("final state != published root")
    if z_fin[11] != 0:
        raise AssertionError("chain did not reach the root (depth != 0)")
    return time.perf_counter() - t0


def worker(args) -> None:
    from ..models.chunk_prover import ChunkProver

    t0 = time.perf_counter()
    prover = ChunkProver(depth_bits=DEPTH_BITS, device=args.device)
    prover.ivc.prepare_key()
    setup_s = time.perf_counter() - t0
    chain = deep_chain(prover, args.steps)
    print(f"witness chain: {args.steps} steps in {chain['witness_s']:.1f} s "
          f"(host digits {chain['canon'].nbytes / 1e9:.2f} GB)",
          file=sys.stderr, flush=True)
    run = prove(prover, chain, args.segments, args.group, args.ckpt,
                progress=True)
    seg = run["proof"]
    if run["proved"] + run["resumed"] != args.segments:
        raise RuntimeError(f"{run['proved']} proved + {run['resumed']} "
                           f"resumed != {args.segments} segments")
    verify_s = verify(prover, chain, seg)
    folds = sum(w["folds"] for w in run["waves"])
    cuda = prover.device.type == "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip() if cuda else None
    out = {
        "card": card,
        "single_chain_steps": args.steps,
        "segments": args.segments,
        "lockstep_group": args.group,
        "depth_bits": DEPTH_BITS,
        "setup_s": setup_s,
        "witness_gen_s": chain["witness_s"],
        "folds_this_run": folds,
        "wall_s": run["wall_s"],
        "agg_folds_per_sec": folds / run["wall_s"],
        "waves": run["waves"],
        "verify_s": verify_s,
        "resumed_segments": run["resumed"],
        "proved_segments": run["proved"],
        "killed_mid_run": run["resumed"] > 0,
        "all_verified": True,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(prover.device)
                              if cuda else None),
        "peak_host_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        "root": chain["pd"].root_hash.hex(),
    }
    print(json.dumps(out), flush=True)


def orchestrate(args) -> dict:
    shutil.rmtree(args.ckpt, ignore_errors=True)
    os.makedirs(args.ckpt, exist_ok=True)
    cmd = [sys.executable, "-m", "hotproofs_tpu_torch.tools.longchain_deep",
           "--worker", "--steps", str(args.steps), "--segments",
           str(args.segments), "--group", str(args.group), "--ckpt",
           args.ckpt, "--device", args.device]
    print(f"orchestrator: worker 1 (killed after {args.group} segment "
          "checkpoints)", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, start_new_session=True)
    try:
        deadline = time.time() + args.kill_timeout
        while time.time() < deadline:
            if child.poll() is not None:
                raise RuntimeError(f"worker 1 exited ({child.returncode}) "
                                   "before the kill")
            done = [f for f in os.listdir(args.ckpt)
                    if f.startswith("segment_") and f.endswith(".json")]
            if len(done) >= args.group:
                print(f"orchestrator: {len(done)} checkpoints on disk; "
                      f"SIGKILL worker 1 (pid {child.pid})",
                      file=sys.stderr, flush=True)
                break
            time.sleep(1)
        else:
            raise RuntimeError("no checkpoints before --kill-timeout")
    finally:
        if child.poll() is None:
            os.killpg(os.getpgid(child.pid), signal.SIGKILL)
            child.wait()
    t_kill = time.perf_counter() - t0
    print("orchestrator: worker 2 (resume and finish)", file=sys.stderr,
          flush=True)
    res = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
    lines = res.stdout.strip().splitlines()
    sys.stderr.write("".join(f"{ln}\n" for ln in lines[:-1]))
    if res.returncode != 0:
        raise RuntimeError(f"worker 2 failed rc={res.returncode}")
    out = json.loads(lines[-1])
    if out["resumed_segments"] < args.group:
        raise RuntimeError(f"worker 2 resumed {out['resumed_segments']} "
                           f"segments, want >= {args.group}")
    out["worker1_until_kill_s"] = t_kill
    out["total_wall_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=4096)
    ap.add_argument("--segments", type=int, default=32)
    ap.add_argument("--group", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(CONFIG.cache_dir,
                                                   "torch_longdeep_ckpt"))
    ap.add_argument("--out", default=None,
                    help="also write the result JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: %(default)s)")
    ap.add_argument("--kill-timeout", type=int, default=5400)
    ap.add_argument("--worker", action="store_true",
                    help="run one prover process (the orchestrator's child)")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"device {args.device}: no CUDA device is "
                         "available; pass --device cpu to run on the CPU")
    if args.worker:
        worker(args)
        return
    out = orchestrate(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
