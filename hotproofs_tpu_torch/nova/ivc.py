"""IVC driver: fold a chain of step instances, verify the chain (port of
hotproofs_tpu/nova/ivc.py: prove_batch, prove_lockstep, verify and
fold_instances_only).

Same proof format (nova/serial.py, shared), same pp digest and the same
Fiat-Shamir absorb order as the reference, so a proof from either package
is byte-identical and verifies under either. Not ported yet: the host
per-step `prove`, checkpoint/resume and the multi-device mesh.

The pending-fold pipeline is the reference's: the fold of step i-1 is
applied on the device in the same launch sequence that computes step i's
cross term, and the comm_T MSM is enqueued before the host folds the
previous instance and hashes this step's transcript prefix, so host work
overlaps the device; the only sync per step is the comm_T readback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

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

    # -- proving --------------------------------------------------------------
    def prove_batch(self, z0: Sequence[int], canon_batch,
                    X_host: List[List[int]], chunk_steps: int = 16,
                    progress: bool = False) -> IVCProof:
        """Fold a chain whose step witnesses are given as canonical digits
        (N, n_vars, 32) (a tensor on any device, or numpy); X_host holds
        each step's public IO as ints. Per chunk of steps: to-Montgomery,
        SpMVs and W commits batched; then the sequential fold loop."""
        return self.prove_lockstep([(z0, canon_batch, X_host)], chunk_steps,
                                   progress)[0]

    def prove_lockstep(self, chains, chunk_steps: int = 16,
                       progress: bool = False) -> List[IVCProof]:
        """Fold K independent chains in lockstep on one device.

        chains: list of (z0, canon (N_k, n_vars, 32), X_host) triples. Each
        chain keeps its own transcript, so every proof is bit-identical to
        its own prove_batch run; chains may differ in length (a finished
        chain folds with r = 0 no-ops)."""
        shape, spec, curve = self.shape, self.shape.field, self.curve
        n_io, K = shape.n_io, len(chains)
        assert K >= 1
        lens = [c[1].shape[0] for c in chains]
        n_max = max(lens)
        self.prepare_key()

        acc_dev, _ = NF.empty_accumulator(shape, batch=(K,))
        acc_insts = [NF.AccumulatorInstance(u=0, X=[0] * n_io)
                     for _ in range(K)]
        trs = [self._new_transcript(c[0]) for c in chains]
        steps_k: List[List[StepClaim]] = [[] for _ in range(K)]
        comm_Ts_k: List[List[Affine]] = [[] for _ in range(K)]
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

        done = 0
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
            aff = self._commit_W(w_jobs)
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
                comm_T_dev = self.ck.commit_many(F.from_mont(spec, T), 256)
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
            T_.count("ivc/folds", sum(
                1 for c in range(K)
                for i in range(done, done + take) if i < lens[c]))
            done += take
            if progress:
                print(f"folded {min(done, n_max)}/{n_max} steps x {K} "
                      "chains")

        if pend is not None:
            acc_dev = NF.fold_witness(spec, acc_dev, *pend, _stack_r())
            _host_fold_pending()
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
