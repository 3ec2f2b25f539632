"""RecursiveSNARK: two-cycle augmented IVC with a verifier whose work does
not grow with the chain (port of hotproofs_tpu/nova/recursive.py), and its
compressed form, CompressedRecursiveProof.

Every step folds the previous step's strict instances into running relaxed
instances, and each side's augmented circuit (circuits/nova_augmented.py)
verifies the other side's fold in-circuit. The final verifier recomputes
two Poseidon state hashes and checks three instances.

This module is the host/device driver. It mirrors the in-circuit RO absorb
sequences exactly (RecursiveRO), keeps the two accumulator witnesses on the
side's device (nova/fold.py, nova/r1cs.py), synthesizes the augmented
witnesses on the host (the DSL's tape evaluator) and commits them with the
side's Pedersen key: msm_bucket, msm_merge and msm_wsum on the card, their
plain versions on the CPU. Proofs are the reference's JSON, byte for byte.

compress replaces the proof's witness vectors by three Spartan arguments
(nova/spartan.py), one per relaxed claim: (U1, W1, E1) on the primary,
(U2, W2, E2) on the secondary and the last strict primary instance u1 taken
as relaxed (u = 1, E = 0, comm_E the identity). Each side's SpartanSystem
is made once, over the side's key and the vk as its pp digest; its matrix
tables come from the h_tables kernel (ops/tables.py).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..circuits import bignat_gadget as BN
from ..circuits import nova_augmented as NA
from ..circuits.dsl import CompiledEvaluator, compile_circuit, eval_witness
from ..ops import curve as C
from ..ops import field as F
from ..ops import poseidon as P
from ..utils.config import require_device
from . import fold as NF
from . import serial
from .ivc import check as _check
from .pedersen import CommitmentKey
from .r1cs import ShapeDevice, matvec_all
from .spartan import SpartanProof, SpartanSystem
from .transcript import digest_of

Affine = Optional[Tuple[int, int]]


# ---------------------------------------------------------------------------
# Host instance state and RO mirrors.
# ---------------------------------------------------------------------------


@dataclass
class RelaxedHost:
    """Running relaxed instance (host scalars over the instance's own
    circuit field; commitments on that side's curve)."""

    comm_W: Affine = None
    comm_E: Affine = None
    u: int = 0
    X: Tuple[int, int] = (0, 0)


@dataclass
class StrictHost:
    comm_W: Affine = None
    X: Tuple[int, int] = (0, 0)


def _pt_enc(pt: Affine) -> List[int]:
    """(x, y, inf) native triple: the circuit's and transcript's encoding."""
    return [0, 0, 1] if pt is None else [int(pt[0]), int(pt[1]), 0]


class RecursiveRO:
    """Host mirror of the in-circuit sponges (must match
    nova_augmented.SpongeAbsorbers and state_hash / fold_gadget exactly)."""

    def __init__(self, pspec: P.PoseidonSpec, tag: int):
        from ..core import native_ff
        if native_ff.available():
            self.sp = native_ff.NativeSponge(pspec,
                                             domain_tag=tag % pspec.field.p)
        else:
            self.sp = P.HostSponge(pspec, domain_tag=tag % pspec.field.p)

    def scalars(self, vs: Sequence[int]) -> "RecursiveRO":
        self.sp.absorb([int(v) for v in vs])
        return self

    def point(self, pt: Affine) -> "RecursiveRO":
        self.sp.absorb(_pt_enc(pt))
        return self

    def bignat(self, v: int) -> "RecursiveRO":
        self.sp.absorb(BN.limbs_of_int(int(v)))
        return self

    def relaxed(self, U: RelaxedHost) -> "RecursiveRO":
        self.point(U.comm_W).point(U.comm_E)
        self.bignat(U.u).bignat(U.X[0]).bignat(U.X[1])
        return self

    def strict(self, u: StrictHost) -> "RecursiveRO":
        self.point(u.comm_W).bignat(u.X[0]).bignat(u.X[1])
        return self

    def squeeze_trunc(self) -> int:
        return self.sp.squeeze() % (1 << NA.CHALLENGE_BITS)


def state_hash_host(pspec, vk: int, k: int, z0, z, U: RelaxedHost) -> int:
    ro = RecursiveRO(pspec, NA.TAG_STATE)
    ro.scalars([vk, k])
    if z0 is not None:
        ro.scalars(z0)
    if z is not None:
        ro.scalars(z)
    ro.relaxed(U)
    return ro.squeeze_trunc()


def fold_challenge_host(pspec, vk: int, U: RelaxedHost, u: StrictHost,
                        T_bar: Affine) -> int:
    ro = RecursiveRO(pspec, NA.TAG_FOLD)
    ro.scalars([vk]).relaxed(U).strict(u).point(T_bar)
    return ro.squeeze_trunc()


def fold_relaxed_host(curve: C.CurveSpec, m: int, U: RelaxedHost,
                      u: StrictHost, T_bar: Affine, r: int) -> RelaxedHost:
    inst = NF.fold_instance(F.field_for(m), curve, NF.AccumulatorInstance(
        u=U.u, X=list(U.X), comm_W=U.comm_W, comm_E=U.comm_E),
        list(u.X), u.comm_W, T_bar, r)
    return RelaxedHost(comm_W=inst.comm_W, comm_E=inst.comm_E, u=inst.u,
                       X=tuple(inst.X))


# ---------------------------------------------------------------------------
# Per-side prover state.
# ---------------------------------------------------------------------------


class Side:
    """One curve's circuit, commitment key and device accumulator."""

    def __init__(self, name: str, circuit_fn, modulus: int,
                 commit_curve: C.CurveSpec, label: bytes,
                 device: torch.device):
        self.name = name
        self.circuit_fn = circuit_fn
        self.device = device
        r1cs, self.layout = compile_circuit(circuit_fn, modulus)
        self.shape = ShapeDevice.from_dsl(r1cs, device)
        _check(self.shape.n_io == 2, "an augmented circuit has 2 public IO")
        self.curve = commit_curve
        self.label = label
        # One power-of-two commit size for the witness commits, the cross
        # terms' and the verifier's recomputes: one key prefix, one layout
        # of its bases.
        self.n_pad = 1 << (max(self.shape.n_wit, self.shape.n_cons)
                           - 1).bit_length()
        self.spec = self.shape.field
        self._ck: Optional[CommitmentKey] = None
        self._compiled_eval = None
        self.spartan: Optional[SpartanSystem] = None   # made by compress
        self.times: Dict[str, float] = {}    # ms a part, since last reset
        self.reset()

    def reset(self) -> None:
        """The default running instance, and no strict one pending."""
        self.acc_dev, _ = NF.empty_accumulator(self.shape)
        self.acc = RelaxedHost()
        self.pending = None   # dict: the strict instance awaiting its fold

    @property
    def ck(self) -> CommitmentKey:
        """The side's Pedersen key, derived (or read from the disk cache)
        on the first real commit."""
        if self._ck is None:
            self._ck = CommitmentKey.create(self.curve, self.label,
                                            self.n_pad, self.device)
        return self._ck

    @property
    def compiled_eval(self) -> CompiledEvaluator:
        """The gadget's walk recorded once and replayed each step."""
        if self._compiled_eval is None:
            self._compiled_eval = CompiledEvaluator(self.circuit_fn,
                                                    self.layout)
        return self._compiled_eval

    @contextlib.contextmanager
    def clock(self, part: str):
        """Add the block's wall ms to times[part]; on the card the block's
        launches are waited for, so each part holds its own device work."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.times[part] = self.times.get(part, 0.0) + \
                (time.perf_counter() - t0) * 1e3

    def _mont_scalar(self, v: int) -> torch.Tensor:
        return torch.from_numpy(F.int_to_limbs(
            v * self.spec.r_mod_p % self.spec.p)).to(self.device)

    def _canon(self, ints) -> torch.Tensor:
        return torch.from_numpy(self.spec.batch_to_limbs(
            [int(v) for v in ints])).to(self.device)

    def ints(self, a: torch.Tensor, mont: bool = True) -> List[int]:
        return F.to_ints(self.spec, a, mont=mont)

    def commit(self, vec_canon: torch.Tensor) -> Affine:
        """Pedersen commitment of canonical digits, zero-padded to n_pad:
        one 256-bit MSM over the key's first n_pad generators (the card's
        msm_bucket, msm_merge and msm_wsum), as an affine int pair."""
        with self.clock("commit"):
            n = vec_canon.shape[0]
            if n < self.n_pad:
                vec_canon = torch.cat([vec_canon, F.zeros(
                    (self.n_pad - n,), vec_canon.device)])
            pt = self.ck.commit(vec_canon, 256)
            return self.ck.affine(tuple(c[None] for c in pt))[0]

    def synthesize(self, inputs, check: bool = True
                   ) -> Tuple[StrictHost, dict]:
        """Run the augmented circuit's evaluator, commit the witness; return
        the strict instance and its device tensors. check=False (the prove
        loop's default) replays the recorded tape without the
        per-constraint asserts; check=True walks the full EvalCtx."""
        with self.clock("synth"):
            if check:
                w = eval_witness(self.circuit_fn, self.layout, inputs,
                                 check=True)
            else:
                w = self.compiled_eval.eval(inputs)
            X = (int(w[1]), int(w[2]))
            canon = self._canon(w)
        with self.clock("device"):
            z_mont = F.to_mont(self.spec, canon)
            az, bz, cz = matvec_all(self.shape, z_mont)
        comm_W = self.commit(canon[1 + self.shape.n_io:])
        return StrictHost(comm_W=comm_W, X=X), {
            "z_mont": z_mont, "az": az, "bz": bz, "cz": cz, "canon": canon}

    def fold_pending(self, pspec, vk: int, m: int):
        """Fold the pending strict instance into the running accumulator;
        returns the T_bar, r and strict instance used (None at the base)."""
        if self.pending is None:
            return None
        strict, dev = self.pending["strict"], self.pending["dev"]
        with self.clock("device"):
            T = NF.cross_term(self.spec, self.acc_dev, dev["az"], dev["bz"],
                              dev["cz"], self._mont_scalar(self.acc.u))
            T_canon = F.from_mont(self.spec, T)
        T_bar = self.commit(T_canon)
        r = fold_challenge_host(pspec, vk, self.acc, strict, T_bar)
        self.acc = fold_relaxed_host(self.curve, m, self.acc, strict,
                                     T_bar, r)
        with self.clock("device"):
            self.acc_dev = NF.fold_witness(
                self.spec, self.acc_dev, dev["z_mont"][1 + self.shape.n_io:],
                dev["az"], dev["bz"], dev["cz"], T, self._mont_scalar(r))
        prev = self.pending
        self.pending = None
        return {"T_bar": T_bar, "r": r, "strict": strict, "prev": prev}


def _relaxed_inputs(prefix: str, U: RelaxedHost) -> dict:
    return {f"{prefix}_cw": _pt_enc(U.comm_W),
            f"{prefix}_ce": _pt_enc(U.comm_E),
            f"{prefix}_u": BN.limbs_of_int(U.u),
            f"{prefix}_x0": BN.limbs_of_int(U.X[0]),
            f"{prefix}_x1": BN.limbs_of_int(U.X[1])}


def _strict_inputs(prefix: str, u: StrictHost) -> dict:
    return {f"{prefix}_cw": _pt_enc(u.comm_W),
            f"{prefix}_x0": BN.limbs_of_int(u.X[0]),
            f"{prefix}_x1": BN.limbs_of_int(u.X[1])}


# ---------------------------------------------------------------------------
# The RecursiveSNARK.
# ---------------------------------------------------------------------------


def _enc_relaxed(U: RelaxedHost) -> dict:
    return {"cw": serial.enc_point(U.comm_W), "ce": serial.enc_point(U.comm_E),
            "u": int(U.u), "x": serial.enc_ints(U.X)}


def _dec_relaxed(r: dict) -> RelaxedHost:
    return RelaxedHost(comm_W=serial.dec_point(r["cw"]),
                       comm_E=serial.dec_point(r["ce"]), u=int(r["u"]),
                       X=tuple(serial.enc_ints(r["x"])))


@dataclass
class RecursiveProof:
    n_steps: int
    z0: List[int]
    z_final: List[int]
    U1: RelaxedHost
    U2: RelaxedHost
    u1: StrictHost
    W1: List[int]
    E1: List[int]
    W2: List[int]
    E2: List[int]
    w1: List[int]        # the last strict primary witness, in full

    def to_dict(self) -> dict:
        return {
            "n_steps": int(self.n_steps),
            "z0": serial.enc_ints(self.z0),
            "z_final": serial.enc_ints(self.z_final),
            "U1": _enc_relaxed(self.U1), "U2": _enc_relaxed(self.U2),
            "u1": {"cw": serial.enc_point(self.u1.comm_W),
                   "x": serial.enc_ints(self.u1.X)},
            "W1": serial.enc_ints(self.W1), "E1": serial.enc_ints(self.E1),
            "W2": serial.enc_ints(self.W2), "E2": serial.enc_ints(self.E2),
            "w1": serial.enc_ints(self.w1),
        }

    @staticmethod
    def from_dict(d: dict) -> "RecursiveProof":
        return RecursiveProof(
            n_steps=int(d["n_steps"]), z0=serial.enc_ints(d["z0"]),
            z_final=serial.enc_ints(d["z_final"]),
            U1=_dec_relaxed(d["U1"]), U2=_dec_relaxed(d["U2"]),
            u1=StrictHost(comm_W=serial.dec_point(d["u1"]["cw"]),
                          X=tuple(serial.enc_ints(d["u1"]["x"]))),
            W1=serial.enc_ints(d["W1"]), E1=serial.enc_ints(d["E1"]),
            W2=serial.enc_ints(d["W2"]), E2=serial.enc_ints(d["E2"]),
            w1=serial.enc_ints(d["w1"]))

    def save(self, path: str) -> None:
        serial.dump("recursive_proof", self.to_dict(), path)

    @staticmethod
    def load(path: str) -> "RecursiveProof":
        return RecursiveProof.from_dict(serial.load("recursive_proof", path))


@dataclass
class CompressedRecursiveProof:
    """A RecursiveProof whose witness vectors are replaced by three Spartan
    arguments: sp1 for (U1, W1, E1), sp2 for (U2, W2, E2), sp_u1 for the
    last strict primary instance taken as relaxed (u = 1, E = 0)."""

    n_steps: int
    z0: List[int]
    z_final: List[int]
    U1: RelaxedHost
    U2: RelaxedHost
    u1: StrictHost
    sp1: SpartanProof
    sp2: SpartanProof
    sp_u1: SpartanProof

    def to_dict(self) -> dict:
        return {
            "n_steps": int(self.n_steps),
            "z0": serial.enc_ints(self.z0),
            "z_final": serial.enc_ints(self.z_final),
            "U1": _enc_relaxed(self.U1), "U2": _enc_relaxed(self.U2),
            "u1": {"cw": serial.enc_point(self.u1.comm_W),
                   "x": serial.enc_ints(self.u1.X)},
            "sp1": self.sp1.to_dict(), "sp2": self.sp2.to_dict(),
            "sp_u1": self.sp_u1.to_dict(),
        }

    @staticmethod
    def from_dict(d: dict) -> "CompressedRecursiveProof":
        return CompressedRecursiveProof(
            n_steps=int(d["n_steps"]), z0=serial.enc_ints(d["z0"]),
            z_final=serial.enc_ints(d["z_final"]),
            U1=_dec_relaxed(d["U1"]), U2=_dec_relaxed(d["U2"]),
            u1=StrictHost(comm_W=serial.dec_point(d["u1"]["cw"]),
                          X=tuple(serial.enc_ints(d["u1"]["x"]))),
            sp1=SpartanProof.from_dict(d["sp1"]),
            sp2=SpartanProof.from_dict(d["sp2"]),
            sp_u1=SpartanProof.from_dict(d["sp_u1"]))

    def save(self, path: str) -> None:
        serial.dump("compressed_recursive_proof", self.to_dict(), path)

    @staticmethod
    def load(path: str) -> "CompressedRecursiveProof":
        return CompressedRecursiveProof.from_dict(
            serial.load("compressed_recursive_proof", path))


def _mat_bytes(r1cs) -> bytes:
    """The bytes the vk hashes for one shape: each matrix's (row, col,
    value mod 2^256) as 4 + 4 + 32 little-endian bytes per entry, then
    (n_constraints, n_signals, n_io) as int64 (the reference's loop, with
    each distinct value encoded once)."""
    entry = np.dtype([("r", "<u4"), ("c", "<u4"), ("v", "V32")])
    parts = []
    for rows, cols, vals in (r1cs.A, r1cs.B, r1cs.C):
        enc: Dict[int, bytes] = {}
        out = np.empty(len(rows), entry)
        out["r"] = np.asarray(rows, np.int64)
        out["c"] = np.asarray(cols, np.int64)
        vb = b"".join(enc.get(v) or enc.setdefault(
            v, (v % (1 << 256)).to_bytes(32, "little"))
            for v in (int(x) for x in vals))
        out["v"] = np.frombuffer(vb, "V32")
        parts.append(out.tobytes())
    parts.append(np.asarray([r1cs.n_constraints, r1cs.n_signals, r1cs.n_io],
                            np.int64).tobytes())
    return b"".join(parts)


class RecursiveSNARK:
    """Two-cycle augmented IVC. f_gadget / f_host: the step function as a
    DSL gadget and its host mirror. The primary is committed on cycle[0]
    (its circuit is over cycle[0]'s scalar field), the secondary on
    cycle[1]. Any 2-cycle works: Pasta (Pallas, Vesta) by default, or
    (BN254, Grumpkin). Runs on `device` (the card unless the caller asks
    for the CPU)."""

    def __init__(self, f_gadget: Callable, f_host: Callable, arity: int,
                 label: bytes = b"recursive",
                 f_extra_decl: Optional[Callable] = None,
                 cycle: Tuple[C.CurveSpec, C.CurveSpec] = (C.PALLAS,
                                                           C.VESTA),
                 device="cuda"):
        self.device = require_device(device)
        cur1, cur2 = cycle
        _check(cur1.scalar.p == cur2.base.p and cur2.scalar.p == cur1.base.p,
              "not a 2-cycle of curves")
        q = cur1.scalar.p       # the primary circuit's field
        p = cur2.scalar.p       # the secondary circuit's field
        self.q, self.p = q, p
        self.arity = arity
        self.f_host = f_host
        self.pspec1 = P.make_spec(cur1.scalar.name)
        self.pspec2 = P.make_spec(cur2.scalar.name)
        self.timings: List[Dict[str, float]] = []   # ms a step, last prove
        # seconds of each Spartan argument's parts, last compress
        self.compress_times: Dict[str, Dict[str, float]] = {}
        # seconds of __init__'s parts: the probes' compile, the vk's bytes
        # and digest, the two sides (circuits, shapes)
        self.setup_times: Dict[str, float] = {}
        t0 = time.perf_counter()

        # The vk binds both probe shapes (every matrix's sparsity and
        # values; vk enters the real circuits only as a hashed constant, so
        # the probes are built with vk = 0) and the key label.
        c1_probe = NA.make_augmented_circuit(
            self.pspec1, cur2.b, p, 0, arity, f_gadget,
            fold_at_base=True, f_extra_decl=f_extra_decl)
        c2_probe = NA.make_augmented_circuit(
            self.pspec2, cur1.b, q, 0, 0, None, fold_at_base=False)
        r1, _ = compile_circuit(c1_probe, q)
        r2, _ = compile_circuit(c2_probe, p)
        t1 = time.perf_counter()
        self.vk = digest_of(label, _mat_bytes(r1), _mat_bytes(r2)) \
            % (1 << NA.CHALLENGE_BITS)
        t2 = time.perf_counter()
        self.setup_times.update(probes=t1 - t0, vk=t2 - t1)

        c1 = NA.make_augmented_circuit(self.pspec1, cur2.b, p, self.vk,
                                       arity, f_gadget, fold_at_base=True,
                                       f_extra_decl=f_extra_decl)
        c2 = NA.make_augmented_circuit(self.pspec2, cur1.b, q, self.vk,
                                       0, None, fold_at_base=False)
        self.side1 = Side("primary", c1, q, cur1,
                          label + b"-" + cur1.name.encode() + b"-1",
                          self.device)
        self.side2 = Side("secondary", c2, p, cur2,
                          label + b"-" + cur2.name.encode() + b"-2",
                          self.device)
        self.setup_times["sides"] = time.perf_counter() - t2

    # -- proving --------------------------------------------------------------
    def prove(self, z0: Sequence[int], n_steps: int,
              step_inputs: Optional[List[dict]] = None,
              progress: bool = False,
              check: bool = False) -> RecursiveProof:
        """step_inputs[k-1]: extra named inputs of F at step k (matching
        f_extra_decl's names), also passed to f_host as its second argument.
        check=True re-asserts every constraint during synthesis. Each
        step's ms (host synthesis per side, device work, commits, wall) are
        left in self.timings."""
        q, p = self.q, self.p
        z0 = [int(v) % q for v in z0]
        z = list(z0)
        s1, s2 = self.side1, self.side2
        s1.reset()
        s2.reset()
        self.timings = []

        for k in range(1, n_steps + 1):
            t_step = time.perf_counter()
            s1.times, s2.times = {}, {}
            # A. Fold the pending primary strict instance (k >= 2) into U1.
            fold1 = s1.fold_pending(self.pspec2, self.vk, q)
            # B. Synthesize C2_k over F_p: it witnesses the state before
            # the fold, and its in-circuit fold must reproduce step A.
            U1_prev = fold1["prev"]["U_before"] if fold1 else RelaxedHost()
            u1_prev = fold1["strict"] if fold1 else StrictHost()
            T1 = fold1["T_bar"] if fold1 else None
            inputs2 = {"k_prev": [k - 1],
                       **_relaxed_inputs("U", U1_prev),
                       **_strict_inputs("u", u1_prev),
                       "T_cw": _pt_enc(T1)}
            u2_k, dev2 = s2.synthesize(inputs2, check=check)
            _check(u2_k.X[0] == state_hash_host(
                self.pspec2, self.vk, k, None, None, s1.acc),
                "C2 output hash != host mirror")
            # C. Fold u2_k into U2 (host and device): C1_k verifies this.
            U2_prev = RelaxedHost(comm_W=s2.acc.comm_W,
                                  comm_E=s2.acc.comm_E, u=s2.acc.u,
                                  X=s2.acc.X)
            s2.pending = {"strict": u2_k, "dev": dev2, "U_before": U2_prev}
            fold2 = s2.fold_pending(self.pspec1, self.vk, p)
            # D. Synthesize C1_k over F_q.
            extra = step_inputs[k - 1] if step_inputs else None
            z_next = [int(v) % q for v in (
                self.f_host(z, extra) if extra is not None
                else self.f_host(z))]
            inputs1 = {"k_prev": [k - 1], "z0": z0, "z_prev": z,
                       **_relaxed_inputs("U", U2_prev),
                       **_strict_inputs("u", u2_k),
                       "T_cw": _pt_enc(fold2["T_bar"]),
                       **(extra or {})}
            u1_k, dev1 = s1.synthesize(inputs1, check=check)
            _check(u1_k.X[0] == state_hash_host(
                self.pspec1, self.vk, k, z0, z_next, s2.acc),
                "C1 output hash != host mirror")
            s1.pending = {"strict": u1_k, "dev": dev1,
                          "U_before": RelaxedHost(
                              comm_W=s1.acc.comm_W, comm_E=s1.acc.comm_E,
                              u=s1.acc.u, X=s1.acc.X)}
            z = z_next
            self.timings.append({
                "synth_primary": s1.times.get("synth", 0.0),
                "synth_secondary": s2.times.get("synth", 0.0),
                "device": s1.times.get("device", 0.0)
                + s2.times.get("device", 0.0),
                "commit": s1.times.get("commit", 0.0)
                + s2.times.get("commit", 0.0),
                "wall": (time.perf_counter() - t_step) * 1e3})
            if progress:
                print(f"recursive step {k}/{n_steps} done")

        # The final state: U1, U2 running; u1_n strict (pending, unfolded).
        pend = s1.pending
        return RecursiveProof(
            n_steps=n_steps, z0=z0, z_final=z,
            U1=s1.acc, U2=s2.acc, u1=pend["strict"],
            W1=s1.ints(s1.acc_dev.W), E1=s1.ints(s1.acc_dev.E),
            W2=s2.ints(s2.acc_dev.W), E2=s2.ints(s2.acc_dev.E),
            w1=s1.ints(pend["dev"]["canon"], mont=False))

    # -- compression ------------------------------------------------------------
    def _spartan(self, side: Side) -> SpartanSystem:
        """The side's SpartanSystem over its shape and key, with the vk as
        its pp digest (made once)."""
        if side.spartan is None:
            side.spartan = SpartanSystem(shape=side.shape, curve=side.curve,
                                         ck=side.ck, pp_digest=self.vk)
        return side.spartan

    def setup_compressed(self) -> None:
        """Prepare what compress and verify_compressed read, on both sides:
        the matrix tables (h_tables, or the disk cache) laid out as MSM
        bases, and the keys' bases at the IPAs' lengths."""
        for side in (self.side1, self.side2):
            self._spartan(side).setup()

    @staticmethod
    def _instances(proof) -> Tuple[NF.AccumulatorInstance, ...]:
        """The three relaxed instances of a final state: U1, U2, and the
        strict u1 with u = 1 and comm_E the identity."""
        rel = lambda U: NF.AccumulatorInstance(u=U.u, X=list(U.X),
                                               comm_W=U.comm_W,
                                               comm_E=U.comm_E)
        return rel(proof.U1), rel(proof.U2), NF.AccumulatorInstance(
            u=1, X=list(proof.u1.X), comm_W=proof.u1.comm_W, comm_E=None)

    def compress(self, proof: RecursiveProof) -> CompressedRecursiveProof:
        """Drop every witness vector: three Spartan arguments instead. The
        seconds of each argument's parts are left in compress_times."""
        i1, i2, iu = self._instances(proof)
        s1, s2 = self.side1, self.side2
        self.compress_times = {}

        def prove(name, side, inst, W, E):
            sps = self._spartan(side)
            sp = sps.prove_relaxed(inst, W, E)
            self.compress_times[name] = dict(sps.timings)
            return sp

        sp1 = prove("sp1", s1, i1, proof.W1, proof.E1)
        sp2 = prove("sp2", s2, i2, proof.W2, proof.E2)
        sp_u1 = prove("sp_u1", s1, iu, proof.w1[1 + s1.shape.n_io:],
                      [0] * s1.shape.n_cons)
        return CompressedRecursiveProof(
            n_steps=proof.n_steps, z0=list(proof.z0),
            z_final=list(proof.z_final), U1=proof.U1, U2=proof.U2,
            u1=proof.u1, sp1=sp1, sp2=sp2, sp_u1=sp_u1)

    def verify_compressed(self, cp: CompressedRecursiveProof) -> List[int]:
        """The two state-hash bindings, then the three Spartan arguments
        (none of which reads a matrix or a witness); returns z_final.
        Raises AssertionError on a proof that does not verify."""
        _check(cp.n_steps >= 1, "no step")
        q = self.q
        z0 = [int(v) % q for v in cp.z0]
        z_final = [int(v) % q for v in cp.z_final]
        h1 = state_hash_host(self.pspec1, self.vk, cp.n_steps, z0, z_final,
                             cp.U2)
        _check(cp.u1.X[0] == h1, "primary state hash mismatch")
        h2 = state_hash_host(self.pspec2, self.vk, cp.n_steps, None, None,
                             cp.U1)
        _check(cp.u1.X[1] == h2, "secondary state hash mismatch")
        i1, i2, iu = self._instances(cp)
        self._spartan(self.side1).verify_relaxed(i1, cp.sp1)
        self._spartan(self.side2).verify_relaxed(i2, cp.sp2)
        self._spartan(self.side1).verify_relaxed(iu, cp.sp_u1)
        return z_final

    # -- verification -----------------------------------------------------------
    def _check_relaxed(self, side: Side, U: RelaxedHost, W: List[int],
                       E: List[int]) -> None:
        spec, shape = side.spec, side.shape
        _check(len(W) == shape.n_wit and len(E) == shape.n_cons,
              f"accumulator length ({side.name})")
        W_canon, E_canon = side._canon(W), side._canon(E)
        for vec, claimed, nm in ((W_canon, U.comm_W, "W"),
                                 (E_canon, U.comm_E, "E")):
            _check(side.commit(vec) == claimed,
                  f"comm_{nm} mismatch ({side.name})")
        u_mont = side._mont_scalar(U.u)
        x_mont = F.to_mont(spec, side._canon(U.X))
        z = torch.cat([u_mont[None], x_mont, F.to_mont(spec, W_canon)])
        az, bz, cz = matvec_all(shape, z)
        lhs = F.mont_mul(spec, az, bz)
        rhs = F.add(spec, F.mont_mul(spec, u_mont[None], cz),
                    F.to_mont(spec, E_canon))
        _check(bool(torch.equal(lhs, rhs)),
              f"relaxed R1CS unsatisfied ({side.name})")

    def verify(self, proof: RecursiveProof) -> List[int]:
        """Hash recomputes and three instance checks, none of which grows
        with n_steps; returns z_final."""
        _check(proof.n_steps >= 1, "no step")
        q = self.q
        z0 = [int(v) % q for v in proof.z0]
        z_final = [int(v) % q for v in proof.z_final]

        # 1. The state-hash bindings of the last strict primary instance.
        h1 = state_hash_host(self.pspec1, self.vk, proof.n_steps, z0,
                             z_final, proof.U2)
        _check(proof.u1.X[0] == h1, "primary state hash mismatch")
        h2 = state_hash_host(self.pspec2, self.vk, proof.n_steps, None,
                             None, proof.U1)
        _check(proof.u1.X[1] == h2, "secondary state hash mismatch")

        # 2. Relaxed satisfaction of both running accumulators.
        self._check_relaxed(self.side1, proof.U1, proof.W1, proof.E1)
        self._check_relaxed(self.side2, proof.U2, proof.W2, proof.E2)

        # 3. Strict satisfaction of u1 (its full witness vector: u = 1,
        # E = 0), its IO binding and its commitment.
        s1 = self.side1
        w = proof.w1
        _check(len(w) == s1.shape.n_vars and w[0] == 1, "u1 witness shape")
        _check((int(w[1]), int(w[2])) == tuple(proof.u1.X), "u1 IO mismatch")
        canon = s1._canon(w)
        _check(s1.commit(canon[1 + s1.shape.n_io:]) == proof.u1.comm_W,
              "u1 commitment mismatch")
        az, bz, cz = matvec_all(s1.shape, F.to_mont(s1.spec, canon))
        _check(bool(torch.equal(F.mont_mul(s1.spec, az, bz), cz)),
              "u1 R1CS unsatisfied")
        return z_final
