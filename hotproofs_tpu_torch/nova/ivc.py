"""IVC driver: fold a chain of step instances, verify the chain (port of
hotproofs_tpu/nova/ivc.py: the per-step prove, prove_batch with
checkpoints, resume and the mesh, prove_lockstep with the mesh, verify and
fold_instances_only).

Same proof and checkpoint formats (nova/serial.py, shared), same pp digest
and the same Fiat-Shamir absorb order as the reference, so a proof or a
checkpoint from either package is byte-identical and loads under either.

The pending-fold pipeline is the reference's: the fold of step i-1 is
applied on the device in the same launch sequence that computes step i's
cross term, and the comm_T MSM is enqueued before the host folds the
previous instance and hashes this step's transcript prefix, so host work
overlaps the device; the only sync per step is the comm_T readback.
prove_batch is that loop at K = 1, started from a checkpoint on resume.

The mesh (parallel/mesh.py) is torch.distributed's: one process a device.
prove_batch(mesh=) runs the one chain on every rank with each chunk's W
commits split over the "step" axis and each comm_T MSM over "msm";
prove_lockstep(mesh=) folds a block of whole chains on each rank and
gathers the proofs. The bytes do not depend on the mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..utils import telemetry as T_
from . import fold as NF
from . import serial
from .pedersen import CommitmentKey
from .r1cs import ShapeDevice, matvec_all, relaxed_satisfied
from .transcript import Transcript, digest_of, transcript_poseidon_params

Affine = NF.Affine


def check(cond: bool, msg: str) -> None:
    """Reject a proof: raise AssertionError(msg) unless cond. A plain
    `assert` would vanish under `python -O` and let the verifier pass
    anything."""
    if not cond:
        raise AssertionError(msg)


@dataclass
class StepClaim:
    """Strict instance of one step: public IO + witness commitment."""

    X: List[int]          # n_io ints: [z_out || z_in]
    comm_W: Affine


@dataclass
class IVCProof:
    z0: List[int]
    steps: List[StepClaim]
    comm_Ts: List[Affine]
    final_W: List[int]    # opened accumulator witness (canonical ints)
    final_E: List[int]
    pp_digest: int

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def z_final(self, io_arity: int) -> List[int]:
        return self.steps[-1].X[:io_arity]

    def to_dict(self) -> dict:
        return {
            "z0": serial.enc_ints(self.z0),
            "steps_X": [serial.enc_ints(s.X) for s in self.steps],
            "steps_comm_W": serial.enc_points(
                [s.comm_W for s in self.steps]),
            "comm_Ts": serial.enc_points(self.comm_Ts),
            "final_W": serial.enc_ints(self.final_W),
            "final_E": serial.enc_ints(self.final_E),
            "pp_digest": int(self.pp_digest),
        }

    @staticmethod
    def from_dict(d: dict) -> "IVCProof":
        steps = [StepClaim(X=serial.enc_ints(x), comm_W=serial.dec_point(w))
                 for x, w in zip(d["steps_X"], d["steps_comm_W"])]
        return IVCProof(
            z0=serial.enc_ints(d["z0"]), steps=steps,
            comm_Ts=serial.dec_points(d["comm_Ts"]),
            final_W=serial.enc_ints(d["final_W"]),
            final_E=serial.enc_ints(d["final_E"]),
            pp_digest=int(d["pp_digest"]))

    def save(self, path: str) -> None:
        serial.dump("ivc_proof", self.to_dict(), path)

    @staticmethod
    def load(path: str) -> "IVCProof":
        return IVCProof.from_dict(serial.load("ivc_proof", path))


@dataclass
class ProverCheckpoint:
    """A chain's state between folds, to resume it after an interruption.

    Every value is an exact int (the device accumulator is saved in
    canonical form and goes back to Montgomery form on resume), so a
    checkpoint is host-portable and its file is the reference's, key for
    key."""

    next_step: int
    z0: List[int]
    steps: List[StepClaim]
    comm_Ts: List[Affine]
    acc_u: int
    acc_X: List[int]
    acc_comm_W: Affine
    acc_comm_E: Affine
    acc_W: List[int]
    acc_E: List[int]
    acc_az: List[int]
    acc_bz: List[int]
    acc_cz: List[int]
    sponge_state: List[int]
    sponge_absorbed: int
    pp_digest: int

    def save(self, path: str) -> None:
        serial.dump("prover_checkpoint", {
            "next_step": self.next_step,
            "z0": serial.enc_ints(self.z0),
            "steps_X": [serial.enc_ints(s.X) for s in self.steps],
            "steps_comm_W": serial.enc_points(
                [s.comm_W for s in self.steps]),
            "comm_Ts": serial.enc_points(self.comm_Ts),
            "acc_u": int(self.acc_u),
            "acc_X": serial.enc_ints(self.acc_X),
            "acc_comm_W": serial.enc_point(self.acc_comm_W),
            "acc_comm_E": serial.enc_point(self.acc_comm_E),
            "acc_W": serial.enc_ints(self.acc_W),
            "acc_E": serial.enc_ints(self.acc_E),
            "acc_az": serial.enc_ints(self.acc_az),
            "acc_bz": serial.enc_ints(self.acc_bz),
            "acc_cz": serial.enc_ints(self.acc_cz),
            "sponge_state": serial.enc_ints(self.sponge_state),
            "sponge_absorbed": int(self.sponge_absorbed),
            "pp_digest": int(self.pp_digest),
        }, path)

    @staticmethod
    def load(path: str) -> "ProverCheckpoint":
        d = serial.load("prover_checkpoint", path)
        steps = [StepClaim(X=serial.enc_ints(x), comm_W=serial.dec_point(w))
                 for x, w in zip(d["steps_X"], d["steps_comm_W"])]
        return ProverCheckpoint(
            next_step=int(d["next_step"]),
            z0=serial.enc_ints(d["z0"]), steps=steps,
            comm_Ts=serial.dec_points(d["comm_Ts"]),
            acc_u=int(d["acc_u"]), acc_X=serial.enc_ints(d["acc_X"]),
            acc_comm_W=serial.dec_point(d["acc_comm_W"]),
            acc_comm_E=serial.dec_point(d["acc_comm_E"]),
            acc_W=serial.enc_ints(d["acc_W"]),
            acc_E=serial.enc_ints(d["acc_E"]),
            acc_az=serial.enc_ints(d["acc_az"]),
            acc_bz=serial.enc_ints(d["acc_bz"]),
            acc_cz=serial.enc_ints(d["acc_cz"]),
            sponge_state=serial.enc_ints(d["sponge_state"]),
            sponge_absorbed=int(d["sponge_absorbed"]),
            pp_digest=int(d["pp_digest"]))


@dataclass
class _ChainState:
    """One chain's running state at a fold boundary, with no fold pending:
    what a checkpoint saves and where a resumed chain starts."""

    acc_dev: NF.AccumulatorDevice      # unbatched (n, 32) Montgomery digits
    acc_inst: NF.AccumulatorInstance
    tr: Transcript
    steps: List[StepClaim]
    comm_Ts: List[Affine]
    next_step: int


class IVC:
    """Prover/verifier pair bound to one step-circuit shape and key; the
    device work runs on the shape's device."""

    def __init__(self, shape: ShapeDevice, curve: C.CurveSpec,
                 ck: CommitmentKey, big_wit_idx: Optional[np.ndarray] = None,
                 label: bytes = b"ivc", pspec=None):
        """big_wit_idx: witness positions that may exceed 2^SMALL_BITS
        (None commits every witness at full width). pspec: explicit
        transcript Poseidon spec (None: the process-wide one)."""
        assert curve.scalar.p == shape.field.p, \
            "commitment curve group order must equal circuit field"
        self.shape, self.curve, self.ck = shape, curve, ck
        self.big_wit_idx = big_wit_idx
        self.label = label
        self.pspec = pspec
        self.device = shape.device
        # ms a step of the last per-step prove: witness (the caller's
        # iterator), device (upload, SpMVs, cross term, fold), commit (the
        # W and comm_T MSMs with their readbacks), host (transcript and
        # instance fold).
        self.timings: List[Dict[str, float]] = []
        ps_params = ((pspec.t, pspec.r_full, pspec.r_partial)
                     if pspec is not None
                     else transcript_poseidon_params(shape.field.name))
        self.pp_digest = digest_of(
            label,
            np.asarray([shape.n_cons, shape.n_vars, shape.n_io],
                       np.int64).tobytes(),
            np.asarray(ps_params, np.int64).tobytes(),
            *[np.asarray(part).tobytes()
              for m in (shape.A, shape.B, shape.C)
              for part in (m.rows, m.cols, m.vals_mont)],
            ck.gens_affine.tobytes(),
        ) % shape.field.p

    # -- helpers --------------------------------------------------------------
    def _mont_rows(self, vals: Sequence[int]) -> torch.Tensor:
        return F.from_ints(self.shape.field, vals, self.device, mont=True)

    def _new_transcript(self, z0: Sequence[int]) -> Transcript:
        spec = self.shape.field
        tr = Transcript(spec.name, self.label, self.pp_digest,
                        pspec=self.pspec)
        tr.absorb_scalars([v % spec.p for v in z0])
        return tr

    @staticmethod
    def _fold_challenge_prefix(tr: Transcript, acc_inst, X_i,
                               comm_W) -> None:
        """Everything a fold challenge absorbs except comm_T."""
        tr.absorb_scalar(acc_inst.u)
        tr.absorb_scalars(acc_inst.X)
        tr.absorb_point(acc_inst.comm_W)
        tr.absorb_point(acc_inst.comm_E)
        tr.absorb_scalars(X_i)
        tr.absorb_point(comm_W)

    @staticmethod
    def _fold_challenge(tr: Transcript, acc_inst, X_i, comm_W,
                        comm_T) -> int:
        IVC._fold_challenge_prefix(tr, acc_inst, X_i, comm_W)
        tr.absorb_point(comm_T)
        return tr.challenge()

    def prepare_key(self) -> None:
        """Pre-scale the key once at full width for every prefix this shape
        commits (W, E, comm_T and the big witness positions)."""
        m = max(self.shape.n_wit, self.shape.n_cons)
        if m <= self.ck.n:
            self.ck.scaled_affine(m, 256)

    def _commit_W(self, w: torch.Tensor) -> List[Affine]:
        """Affine W commitments of a (J, n_wit, 32) canonical batch."""
        if self.big_wit_idx is None:
            pt = self.ck.commit_many(w, 256)
        else:
            pt = self.ck.commit_many_split(w, self.big_wit_idx)
        return self.ck.affine(pt)

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, torch.int32)

    def _finish_proof(self, z0, steps, comm_Ts, acc_dev) -> IVCProof:
        spec = self.shape.field
        return IVCProof(z0=list(z0), steps=steps, comm_Ts=comm_Ts,
                        final_W=F.to_ints(spec, acc_dev.W, mont=True),
                        final_E=F.to_ints(spec, acc_dev.E, mont=True),
                        pp_digest=self.pp_digest)

    def _sync(self) -> None:
        """Wait for the device (the per-step prover's timings)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- proving --------------------------------------------------------------
    def prove(self, z0: Sequence[int], witnesses: Iterable,
              progress: bool = False) -> IVCProof:
        """Fold the chain one step at a time: the reference's cross-check
        of the batched path, with the same bytes. `witnesses` yields full
        DSL witness vectors ([1, z_out, z_in, priv..., aux...] ints) in
        step order. Per step: the W commit (split when big_wit_idx is set),
        the cross term and the commit of T, the challenge, the folds of the
        witness and of the instance. Each step's ms are left in
        self.timings."""
        shape, spec, curve = self.shape, self.shape.field, self.curve
        n_io = shape.n_io
        self.prepare_key()
        acc_dev, acc_inst = NF.empty_accumulator(shape)
        tr = self._new_transcript(z0)
        steps: List[StepClaim] = []
        comm_Ts: List[Affine] = []
        self.timings = []
        it = iter(witnesses)
        while True:
            t0 = time.perf_counter()
            w_ints = next(it, None)
            if w_ints is None:
                break
            t1 = time.perf_counter()
            canon = F.from_ints(spec, w_ints, self.device)
            X_i = [int(v) % spec.p for v in w_ints[1:1 + n_io]]
            z_mont = F.to_mont(spec, canon)
            az, bz, cz = matvec_all(shape, z_mont)
            self._sync()
            t2 = time.perf_counter()
            comm_W = self._commit_W(canon[None, 1 + n_io:])[0]
            t3 = time.perf_counter()
            T = NF.cross_term(spec, acc_dev, az, bz, cz,
                              self._mont_rows([acc_inst.u])[0])
            self._sync()
            t4 = time.perf_counter()
            comm_T = self.ck.affine(self.ck.commit_many(
                F.from_mont(spec, T)[None], 256))[0]
            t5 = time.perf_counter()
            r = self._fold_challenge(tr, acc_inst, X_i, comm_W, comm_T)
            acc_inst = NF.fold_instance(spec, curve, acc_inst, X_i, comm_W,
                                        comm_T, r)
            t6 = time.perf_counter()
            acc_dev = NF.fold_witness(spec, acc_dev, z_mont[1 + n_io:], az,
                                      bz, cz, T, self._mont_rows([r])[0])
            self._sync()
            t7 = time.perf_counter()
            steps.append(StepClaim(X=X_i, comm_W=comm_W))
            comm_Ts.append(comm_T)
            self.timings.append({
                "witness": (t1 - t0) * 1e3,
                "device": (t2 - t1 + t4 - t3 + t7 - t6) * 1e3,
                "commit": (t3 - t2 + t5 - t4) * 1e3,
                "host": (t6 - t5) * 1e3})
            if progress:
                print(f"fold step {len(steps) - 1}: done")
        return self._finish_proof(z0, steps, comm_Ts, acc_dev)

    def prove_batch(self, z0: Sequence[int], canon_batch,
                    X_host: List[List[int]], chunk_steps: int = 16,
                    progress: bool = False,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 0,
                    resume: Optional[ProverCheckpoint] = None,
                    mesh=None) -> IVCProof:
        """Fold a chain whose step witnesses are given as canonical digits
        (N, n_vars, 32) (a tensor on any device, or numpy); X_host holds
        each step's public IO as ints. Per chunk of steps: to-Montgomery,
        SpMVs and W commits batched; then the sequential fold loop.

        checkpoint_every > 0 saves a ProverCheckpoint to checkpoint_path
        after every that-many folds (not after the last); resume= continues
        from a loaded checkpoint (canon_batch and X_host are the whole
        chain's, as in the run that saved it).

        mesh: a DeviceMesh with the dimensions ("step", "msm")
        (parallel/mesh.make_mesh) on the IVC's device type. Every rank folds
        the one chain; each chunk's W commits are split over "step" and
        each comm_T MSM over "msm", and every rank gathers all the points,
        so every rank's transcript and proof are the same. The reference
        refused the mesh on one of its two TPU MSM paths
        (HOTPROOFS_PALLAS_MSM); the port has one MSM path, so no such
        check carries over."""
        start = None if resume is None else self._resume(z0, resume)
        ckpt = (checkpoint_path, checkpoint_every) \
            if checkpoint_every and checkpoint_path else None
        commit_W = commit_T = None
        if mesh is not None:
            commit_W, commit_T = self._mesh_commits(mesh, chunk_steps)
        return self._fold_chains([(z0, canon_batch, X_host)], chunk_steps,
                                 progress, start, ckpt, commit_W,
                                 commit_T)[0]

    def prove_lockstep(self, chains, chunk_steps: int = 16,
                       progress: bool = False, mesh=None,
                       mesh_axis: str = "chain") -> List[IVCProof]:
        """Fold K independent chains in lockstep on one device.

        chains: list of (z0, canon (N_k, n_vars, 32), X_host) triples. Each
        chain keeps its own transcript, so every proof is bit-identical to
        its own prove_batch run; chains may differ in length (a finished
        chain folds with r = 0 no-ops).

        mesh: a DeviceMesh with a `mesh_axis` dimension (chain per device):
        K must divide by its size D, rank r folds chains
        [r K/D, (r+1) K/D) on its own device, and the proofs are gathered
        in chain order, so every rank returns all K. As in prove_batch, the
        reference's HOTPROOFS_PALLAS_MSM check has nothing to choose here."""
        if mesh is None:
            return self._fold_chains(chains, chunk_steps, progress)
        from ..parallel import mesh as M
        M.check_device(mesh, self.device)
        D = mesh.get_group(mesh_axis).size()
        K = len(chains)
        check(K % D == 0, f"K={K} must divide by mesh axis {D}")
        blk, r = K // D, mesh.get_local_rank(mesh_axis)
        mine = self._fold_chains(chains[r * blk:(r + 1) * blk], chunk_steps,
                                 progress)
        parts: List = [None] * D
        torch.distributed.all_gather_object(
            parts, mine, group=mesh.get_group(mesh_axis))
        return [p for part in parts for p in part]

    def _resume(self, z0: Sequence[int],
                cp: ProverCheckpoint) -> _ChainState:
        """A checkpoint's chain state, its accumulator back in Montgomery
        form on the device and its sponge in the transcript."""
        shape, spec = self.shape, self.shape.field
        check(cp.pp_digest == self.pp_digest,
              "checkpoint is for a different circuit/key")
        check(cp.next_step == len(cp.steps) == len(cp.comm_Ts)
              and len(cp.acc_X) == shape.n_io
              and len(cp.acc_W) == shape.n_wit
              and all(len(v) == shape.n_cons for v in (
                  cp.acc_E, cp.acc_az, cp.acc_bz, cp.acc_cz)),
              "corrupt checkpoint")
        mont = lambda v: F.to_mont(spec, F.from_ints(spec, v, self.device))
        acc_dev = NF.AccumulatorDevice(
            W=mont(cp.acc_W), E=mont(cp.acc_E), az=mont(cp.acc_az),
            bz=mont(cp.acc_bz), cz=mont(cp.acc_cz))
        tr = self._new_transcript(z0)
        tr.sponge.state = [v % spec.p for v in cp.sponge_state]
        tr.sponge._absorbed = cp.sponge_absorbed
        inst = NF.AccumulatorInstance(u=cp.acc_u, X=list(cp.acc_X),
                                      comm_W=cp.acc_comm_W,
                                      comm_E=cp.acc_comm_E)
        return _ChainState(acc_dev, inst, tr, list(cp.steps),
                           list(cp.comm_Ts), cp.next_step)

    def _checkpoint(self, st: _ChainState, z0) -> ProverCheckpoint:
        """The checkpoint of a chain's state (no fold pending)."""
        ints = lambda a: F.to_ints(self.shape.field, a, mont=True)
        acc, inst = st.acc_dev, st.acc_inst
        return ProverCheckpoint(
            next_step=st.next_step, z0=list(z0), steps=list(st.steps),
            comm_Ts=list(st.comm_Ts), acc_u=inst.u, acc_X=list(inst.X),
            acc_comm_W=inst.comm_W, acc_comm_E=inst.comm_E,
            acc_W=ints(acc.W), acc_E=ints(acc.E), acc_az=ints(acc.az),
            acc_bz=ints(acc.bz), acc_cz=ints(acc.cz),
            sponge_state=list(st.tr.sponge.state),
            sponge_absorbed=st.tr.sponge._absorbed,
            pp_digest=self.pp_digest)

    def _mesh_commits(self, mesh, chunk_steps: int):
        """prove_batch's commits on a ("step", "msm") mesh: (W commits of
        a chunk's jobs -> affine points, comm_T of (1, n_cons, 32) ->
        projective point)."""
        from ..parallel import mesh as M
        from ..parallel.msm_sharded import msm_sharded
        M.check_device(mesh, self.device)
        step = mesh.get_group("step").size()
        check(chunk_steps % step == 0,
              f"chunk_steps {chunk_steps} must divide by step axis {step}")

        def commit_W(w: torch.Tensor) -> List[Affine]:
            # A short last chunk is padded with zero witnesses to a
            # multiple of the axis; their commits are dropped.
            J = w.shape[0]
            if J % step:
                w = torch.cat([w, w.new_zeros((step - J % step,)
                                              + tuple(w.shape[1:]))])
            pt = self.ck.commit_many_mesh(w, mesh, 256, axis="step",
                                          big_idx=self.big_wit_idx)
            return self.ck.affine(tuple(c[:J] for c in pt))

        def commit_T(t: torch.Tensor) -> C.Point:
            return msm_sharded(self.ck, mesh, t, 256, axis="msm")

        return commit_W, commit_T

    def _fold_chains(self, chains, chunk_steps: int, progress: bool,
                     start: Optional[_ChainState] = None, ckpt=None,
                     commit_W=None, commit_T=None) -> List[IVCProof]:
        """The pipelined fold loop of prove_batch and prove_lockstep.
        start: one chain's state to resume from; ckpt: (path, every) to
        save one chain's checkpoints; commit_W / commit_T: the mesh's
        commits (default: the key's on this device)."""
        shape, spec, curve = self.shape, self.shape.field, self.curve
        n_io, K = shape.n_io, len(chains)
        assert K >= 1 and (K == 1 or (start is None and ckpt is None))
        lens = [c[1].shape[0] for c in chains]
        n_max = max(lens)
        self.prepare_key()
        commit_W = commit_W or self._commit_W
        commit_T = commit_T or (lambda t: self.ck.commit_many(t, 256))

        if start is None:
            acc_dev, _ = NF.empty_accumulator(shape, batch=(K,))
            acc_insts = [NF.AccumulatorInstance(u=0, X=[0] * n_io)
                         for _ in range(K)]
            trs = [self._new_transcript(c[0]) for c in chains]
            steps_k: List[List[StepClaim]] = [[] for _ in range(K)]
            comm_Ts_k: List[List[Affine]] = [[] for _ in range(K)]
            done = 0
        else:
            acc_dev = NF.AccumulatorDevice(*(a[None] for a in start.acc_dev))
            acc_insts, trs = [start.acc_inst], [start.tr]
            steps_k, comm_Ts_k = [start.steps], [start.comm_Ts]
            done = start.next_step
        # pend: the previous step's stacked tensors, folded on the device by
        # the next step; pend_meta[c] is its host half (None: no live fold).
        pend = None
        pend_meta: List[Optional[dict]] = [None] * K

        def _stack_r():
            return self._mont_rows([0 if m is None else m["r"]
                                    for m in pend_meta])

        def _host_fold_pending():
            for c in range(K):
                m = pend_meta[c]
                if m is not None:
                    acc_insts[c] = NF.fold_instance(
                        spec, curve, acc_insts[c], m["X"], m["comm_W"],
                        m["comm_T"], m["r"])
                    pend_meta[c] = None

        def _flush():
            """Apply the pending folds, on the device and on the host."""
            nonlocal acc_dev, pend
            if pend is not None:
                acc_dev = NF.fold_witness(spec, acc_dev, *pend, _stack_r())
                pend = None
                _host_fold_pending()

        while done < n_max:
            take = min(chunk_steps, n_max - done)
            rows = []
            for c in range(K):
                part = self._to_device(
                    chains[c][1][min(done, lens[c]):min(done + take,
                                                        lens[c])])
                if part.shape[0] < take:   # finished chain: zero witnesses
                    part = torch.cat([part, torch.zeros(
                        (take - part.shape[0],) + tuple(part.shape[1:]),
                        dtype=torch.int32, device=self.device)])
                rows.append(part)
            z_mont, az_b, bz_b, cz_b = [], [], [], []
            for c in range(K):
                zm = F.to_mont(spec, rows[c])
                a_c, b_c, c_c = matvec_all(shape, zm)
                z_mont.append(zm)
                az_b.append(a_c)
                bz_b.append(b_c)
                cz_b.append(c_c)
            z_mont, az_b, bz_b, cz_b = (torch.stack(x) for x in
                                        (z_mont, az_b, bz_b, cz_b))
            # All K chains' W commits of the chunk in one batched MSM.
            w_jobs = torch.stack([r[:, 1 + n_io:] for r in rows]).reshape(
                K * take, shape.n_wit, F.N_LIMBS)
            aff = commit_W(w_jobs)
            commW_aff = [aff[c * take:(c + 1) * take] for c in range(K)]

            for k in range(take):
                i = done + k
                live = [c for c in range(K) if i < lens[c]]
                if not live:
                    break
                u_rows = self._mont_rows([
                    acc_insts[c].u if pend_meta[c] is None
                    else acc_insts[c].u + pend_meta[c]["r"]
                    for c in range(K)])
                if pend is not None:
                    acc_dev = NF.fold_witness(spec, acc_dev, *pend,
                                              _stack_r())
                T = NF.cross_term(spec, acc_dev, az_b[:, k], bz_b[:, k],
                                  cz_b[:, k], u_rows)
                comm_T_dev = commit_T(F.from_mont(spec, T))
                # Host work overlapping the device: fold the pending
                # instances, hash this step's transcript prefixes.
                _host_fold_pending()
                X_i = {}
                for c in live:
                    X_i[c] = [v % spec.p for v in chains[c][2][i]]
                    self._fold_challenge_prefix(trs[c], acc_insts[c], X_i[c],
                                                commW_aff[c][k])
                comm_T_aff = self.ck.affine(comm_T_dev)          # sync
                for c in live:
                    comm_W = commW_aff[c][k]
                    trs[c].absorb_point(comm_T_aff[c])
                    r = trs[c].challenge()
                    pend_meta[c] = {"r": r, "X": X_i[c], "comm_W": comm_W,
                                    "comm_T": comm_T_aff[c]}
                    steps_k[c].append(StepClaim(X=X_i[c], comm_W=comm_W))
                    comm_Ts_k[c].append(comm_T_aff[c])
                pend = (z_mont[:, k, 1 + n_io:], az_b[:, k], bz_b[:, k],
                        cz_b[:, k], T)
                if ckpt is not None and (i + 1) % ckpt[1] == 0 \
                        and i + 1 < n_max:
                    _flush()
                    self._checkpoint(_ChainState(
                        NF.AccumulatorDevice(*(a[0] for a in acc_dev)),
                        acc_insts[0], trs[0], steps_k[0], comm_Ts_k[0],
                        i + 1), chains[0][0]).save(ckpt[0])
            T_.count("ivc/folds", sum(
                1 for c in range(K)
                for i in range(done, done + take) if i < lens[c]))
            done += take
            if progress:
                print(f"folded {min(done, n_max)}/{n_max} steps x {K} "
                      "chains")

        _flush()
        return [self._finish_proof(chains[c][0], steps_k[c], comm_Ts_k[c],
                                   NF.AccumulatorDevice(*(a[c]
                                                          for a in acc_dev)))
                for c in range(K)]

    # -- verification ---------------------------------------------------------
    def fold_instances_only(self, proof: IVCProof,
                            io_arity: int) -> NF.AccumulatorInstance:
        """Replay the transcript and the instance folds of a proof, checking
        its pp digest, step count and IO chaining, without the final
        witness openings: the folded instance that verify opens, and that
        a compressed proof (nova/spartan.py) proves instead of shipping
        final_W and final_E."""
        shape, spec, curve = self.shape, self.shape.field, self.curve
        n_io = shape.n_io
        check(proof.pp_digest == self.pp_digest, "pp digest mismatch")
        check(proof.num_steps >= 1, "empty proof")
        check(len(proof.comm_Ts) == proof.num_steps, "comm_T count mismatch")

        tr = self._new_transcript(proof.z0)
        acc_inst = NF.AccumulatorInstance(u=0, X=[0] * n_io)
        prev_out = [v % spec.p for v in proof.z0]
        for step, comm_T in zip(proof.steps, proof.comm_Ts):
            check(len(step.X) == n_io, "IO length")
            check([v % spec.p for v in step.X[io_arity: 2 * io_arity]]
                  == prev_out, "IO chaining broken")
            prev_out = [v % spec.p for v in step.X[:io_arity]]
            r = self._fold_challenge(tr, acc_inst, step.X, step.comm_W,
                                     comm_T)
            acc_inst = NF.fold_instance(spec, curve, acc_inst, step.X,
                                        step.comm_W, comm_T, r)
        return acc_inst

    def verify(self, proof: IVCProof, io_arity: int) -> List[int]:
        """Full verification; returns z_final on success, raises
        AssertionError on failure. Replays the transcript and the instance
        folds (fold_instances_only), checks the openings of the final W and
        E, and relaxed-R1CS satisfaction of the folded instance."""
        shape, spec = self.shape, self.shape.field
        acc_inst = self.fold_instances_only(proof, io_arity)
        check(len(proof.final_W) == shape.n_wit, "final W length")
        check(len(proof.final_E) == shape.n_cons, "final E length")

        self.prepare_key()
        W_canon = F.from_ints(spec, proof.final_W, self.device)
        E_canon = F.from_ints(spec, proof.final_E, self.device)
        got_W = self.ck.affine(self.ck.commit(W_canon))[0]
        got_E = self.ck.affine(self.ck.commit(E_canon))[0]
        check(got_W == acc_inst.comm_W, "final W commitment mismatch")
        check(got_E == acc_inst.comm_E, "final E commitment mismatch")

        ok = relaxed_satisfied(
            shape, self._mont_rows([acc_inst.u])[0],
            self._mont_rows(acc_inst.X), F.to_mont(spec, W_canon),
            F.to_mont(spec, E_canon))
        check(ok, "relaxed R1CS not satisfied")
        return proof.steps[-1].X[:io_arity]
