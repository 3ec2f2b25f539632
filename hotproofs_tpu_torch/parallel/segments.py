"""Segment-parallel proving of one long IVC chain (port of
hotproofs_tpu/parallel/segments.py; the same proofs and files).

The public state chain z_0 -> z_1 -> ... -> z_n depends only on the hash
chain, which the host computes up front (circuits/blake3_nova.z_chain), not
on the folds. So an n-step chain splits into K segments proved as K
independent IVC chains and composed by public-IO chaining:

    segment k proves  z_{a_k} -> z_{b_k}  in b_k - a_k steps, a_{k+1} = b_k.

Each segment has its own transcript (domain-separated by its own z0) and its
own folded accumulator; the verifier checks every segment and that segment
k's z_out is segment k+1's z0. A segment's proof is byte-equal to a
standalone `IVC.prove_batch` over its range.

Two paths, the same bytes:
  * lockstep: groups of segments fold together through IVC.prove_lockstep
    on the IVC's device (one launch sequence a step for the whole group),
    checkpointed group by group;
  * thread pool: one `prove_batch` a segment, optionally pinned to devices
    of the caller's list, with retries, per-segment verification and
    checkpoints.
Counters (utils/telemetry): `segments/proved`, `segments/resumed`,
`segments/retried`; span `segments/lockstep_wave`.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..nova import serial
from ..nova.ivc import IVC, IVCProof, check
from ..nova.pedersen import CommitmentKey
from ..nova.r1cs import ShapeDevice
from ..utils import telemetry as T


def split_plan(n_steps: int, n_segments: int) -> List[Tuple[int, int]]:
    """[start, end) step ranges, sizes as equal as possible, every segment
    non-empty (n_segments is clamped to n_steps)."""
    k = max(1, min(n_segments, n_steps))
    base, extra = divmod(n_steps, k)
    bounds, a = [], 0
    for i in range(k):
        b = a + base + (1 if i < extra else 0)
        bounds.append((a, b))
        a = b
    return bounds


@dataclass
class SegmentedProof:
    """K independent IVC proofs composed by public-IO chaining."""

    segments: List[IVCProof]

    @property
    def num_steps(self) -> int:
        return sum(s.num_steps for s in self.segments)

    @property
    def z0(self) -> List[int]:
        return self.segments[0].z0

    def z_final(self, io_arity: int) -> List[int]:
        return self.segments[-1].z_final(io_arity)

    def to_dict(self) -> dict:
        return {"segments": [s.to_dict() for s in self.segments]}

    @staticmethod
    def from_dict(d: dict) -> "SegmentedProof":
        return SegmentedProof(
            segments=[IVCProof.from_dict(s) for s in d["segments"]])

    def save(self, path: str) -> None:
        serial.dump("segmented_proof", self.to_dict(), path)

    @staticmethod
    def load(path: str) -> "SegmentedProof":
        return SegmentedProof.from_dict(serial.load("segmented_proof", path))


def _save(proof: IVCProof, path: str) -> None:
    """Write a checkpoint under a temporary name, then rename it: a process
    killed mid-write leaves no truncated segment file behind."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proof.save(tmp)
    os.replace(tmp, path)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _ivc_on(ivc: IVC, device, cache: Dict[str, IVC]) -> IVC:
    """ivc itself, or a copy of it with its shape and key on `device` (same
    pp digest), its key prepared. Called before the pool starts: key
    preparation writes the disk cache through a per-process name, which
    two threads must not share."""
    dev = torch.device(device)
    if _same_device(dev, ivc.device):
        return ivc
    if str(dev) not in cache:
        s, ck = ivc.shape, ivc.ck
        other = IVC(ShapeDevice(s.field, s.n_cons, s.n_vars, s.n_io, s.A,
                                s.B, s.C, device=dev), ivc.curve,
                    CommitmentKey(ck.spec, ck.n, ck.gens_affine, ck.label,
                                  dev),
                    ivc.big_wit_idx, label=ivc.label, pspec=ivc.pspec)
        other.prepare_key()
        cache[str(dev)] = other
    return cache[str(dev)]


def prove_segments(ivc: IVC, zs: Sequence[Sequence[int]], canon,
                   X_host: List[List[int]], n_segments: int,
                   devices: Optional[Sequence] = None,
                   my_segments: Optional[Sequence[int]] = None,
                   max_workers: Optional[int] = None,
                   lockstep: bool = False,
                   lockstep_group: Optional[int] = None,
                   retries: int = 1,
                   verify_each: bool = False,
                   checkpoint_dir: Optional[str] = None,
                   on_wave: Optional[Callable[[List[int], float], None]]
                   = None,
                   progress: bool = False) -> SegmentedProof:
    """Prove the chain (canon, X_host) as n_segments independent segments.

    zs: the public state chain [z_0 .. z_n]; segment k starts from
    zs[a_k]. canon: the (n, n_vars, 32) canonical step witnesses, a tensor
    on any device or numpy; each chunk of steps is uploaded when it is
    folded. devices: pin segment k to devices[k % len(devices)] (thread
    pool only). my_segments: prove only these segments (the others are
    None in .segments, for a caller that composes across processes).

    lockstep=True folds groups of `lockstep_group` segments (default all)
    together on the IVC's device; with checkpoint_dir set, each finished
    group's proofs are written, so a killed run resumes at group
    granularity. on_wave(segments, seconds) is called after each wave,
    once its proofs are checkpointed, with the wave's segment indices and
    its time; an exception it raises ends the call, leaving on disk what a
    kill after that wave would.

    Failures (thread pool): a segment whose prove raises is tried again up
    to `retries` more times, each time on the next device of `devices`
    (on the same device without a list); verify_each=True verifies each
    segment as soon as it is proved (and each resumed checkpoint), and a
    failed verify counts as a failure. checkpoint_dir: each segment's proof
    is written as `segment_{k:05d}.json` (an IVCProof file); a rerun
    resumes every file that belongs to this job (same pp digest, length,
    z0 and z_out) and proves the rest.
    """
    n_steps = canon.shape[0]
    check(len(X_host) == n_steps and len(zs) == n_steps + 1,
          "chain lengths disagree")
    bounds = split_plan(n_steps, n_segments)
    io_arity = len(zs[0])   # state arity (X rows are [z_out || z_in])
    fp = ivc.shape.field.p

    def _ckpt_path(k: int) -> Optional[str]:
        if checkpoint_dir is None:
            return None
        os.makedirs(checkpoint_dir, exist_ok=True)
        return os.path.join(checkpoint_dir, f"segment_{k:05d}.json")

    def _try_resume(k: int) -> Optional[IVCProof]:
        path = _ckpt_path(k)
        if path is None or not os.path.exists(path):
            return None
        a, b = bounds[k]
        try:
            p = IVCProof.load(path)
            # This job's segment k: same circuit and key, length and
            # boundary states. A full verify only with verify_each, so a
            # clean restart stays cheap.
            check(p.pp_digest == ivc.pp_digest, "foreign checkpoint")
            check(p.num_steps == b - a, "wrong segment length")
            check([v % fp for v in p.z0[:io_arity]]
                  == [v % fp for v in zs[a][:io_arity]], "wrong z0")
            check([v % fp for v in p.z_final(io_arity)]
                  == [v % fp for v in zs[b][:io_arity]], "wrong z_out")
            if verify_each:
                ivc.verify(p, io_arity=io_arity)
        except Exception:   # stale, foreign or corrupt: prove it again
            return None
        T.count("segments/resumed")
        if progress:
            print(f"segment {k}: resumed from {path}")
        return p

    if lockstep:
        check(my_segments is None and devices is None,
              "lockstep proves all segments on the IVC's device")
        # Retries are the thread pool's; a failed lockstep wave fails the
        # call (finished waves still resume).
        check(retries == 1, "retries require lockstep=False")
        chunk = min(16, max(b - a for a, b in bounds))
        segs: List[Optional[IVCProof]] = [_try_resume(k)
                                          for k in range(len(bounds))]
        todo = [k for k, s in enumerate(segs) if s is None]
        group = lockstep_group or max(1, len(todo))
        for gi in range(0, len(todo), group):
            ks = todo[gi: gi + group]
            chains = [(list(zs[bounds[k][0]]),
                       canon[bounds[k][0]: bounds[k][1]],
                       X_host[bounds[k][0]: bounds[k][1]]) for k in ks]
            with T.span("segments/lockstep_wave", wave=str(gi // group),
                        k=str(len(ks))) as wave:
                proofs = ivc.prove_lockstep(chains, chunk_steps=chunk,
                                            progress=progress)
            for k, pk in zip(ks, proofs):
                if verify_each:
                    ivc.verify(pk, io_arity=io_arity)
                path = _ckpt_path(k)
                if path is not None:
                    _save(pk, path)
                T.count("segments/proved")
                segs[k] = pk
            if progress:
                print(f"lockstep wave done: segments {ks}")
            if on_wave is not None:
                on_wave(ks, wave.s)
        return SegmentedProof(segments=segs)

    check(on_wave is None, "on_wave requires lockstep=True")
    todo = list(range(len(bounds))) if my_segments is None \
        else sorted(set(my_segments))
    # One chunk size for every segment (their sizes differ by at most 1).
    chunk = min(16, bounds[0][1] - bounds[0][0])
    # Every device's copy of the IVC is made and its key prepared here,
    # before any thread starts.
    copies: Dict[str, IVC] = {}
    ivcs = [_ivc_on(ivc, d, copies) for d in devices] if devices \
        else [ivc]
    ivc.prepare_key()

    def prove_one(k: int) -> IVCProof:
        a, b = bounds[k]
        last_err: Optional[BaseException] = None
        for attempt in range(retries + 1):
            # A retry moves to the next device of the list.
            dev_ivc = ivcs[(k + attempt) % len(ivcs)]
            try:
                p = dev_ivc.prove_batch(list(zs[a]), canon[a:b],
                                        X_host[a:b], chunk_steps=chunk)
                if verify_each:
                    ivc.verify(p, io_arity=io_arity)
                break
            except Exception as e:  # noqa: BLE001 (device faults vary)
                last_err = e
                T.count("segments/retried")
                if progress:
                    print(f"segment {k}: attempt {attempt} failed "
                          f"({type(e).__name__}: {e}); "
                          f"{retries - attempt} retries left")
        else:
            raise RuntimeError(
                f"segment {k} failed after {retries + 1} attempts"
            ) from last_err
        path = _ckpt_path(k)
        if path is not None:
            _save(p, path)
        T.count("segments/proved")
        if progress:
            print(f"segment {k}: steps [{a},{b}) done")
        return p

    results = {k: p for k in todo
               if (p := _try_resume(k)) is not None}
    left = [k for k in todo if k not in results]
    # The first segment to prove runs alone: it fills the lazy caches of
    # the key (base layouts) and registers the transcript's sponge and the
    # curve with the native library, whose registries must not grow while
    # other threads read them. The rest run in the pool, each launch on
    # its thread's current stream.
    if left:
        results[left[0]] = prove_one(left[0])
    if len(left) > 1:
        with ThreadPoolExecutor(max_workers=max_workers
                                or len(left) - 1) as ex:
            futs = {k: ex.submit(prove_one, k) for k in left[1:]}
            results.update({k: f.result() for k, f in futs.items()})
    segments: List[Optional[IVCProof]] = [None] * len(bounds)
    for k, p in results.items():
        segments[k] = p
    if my_segments is None:
        check(all(s is not None for s in segments), "a segment is missing")
    return SegmentedProof(segments=segments)


def verify_segments(ivc: IVC, proof: SegmentedProof,
                    io_arity: int) -> List[int]:
    """Verify every segment and the boundary chaining; returns z_final.

    The caller still checks the statement: proof.z0 against the expected
    initial state and the returned z_final against the claim (e.g.
    models/chunk_prover.check_statement / check_final)."""
    check(bool(proof.segments), "empty segmented proof")
    p = ivc.shape.field.p
    prev_out: Optional[List[int]] = None
    for k, seg in enumerate(proof.segments):
        check(seg is not None, f"segment {k} missing")
        if prev_out is not None:
            check([v % p for v in seg.z0[:io_arity]] == prev_out,
                  f"segment {k} does not chain from segment {k - 1}")
        prev_out = [v % p for v in ivc.verify(seg, io_arity=io_arity)]
    return prev_out
