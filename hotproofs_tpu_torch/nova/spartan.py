"""Spartan compression of the folded relaxed R1CS claim (port of
hotproofs_tpu/nova/spartan.py: the same argument, transcript and proof
format, so a compressed proof from either package is byte-identical and
verifies under either).

After the IVC fold chain the prover ships no accumulator witness. It
proves that the folded instance (u, X, comm_W, comm_E) is satisfied:

  * sum-check 1 over s = log2(m) variables, degree 3:
        0 = sum_x eq(tau, x) (Az(x) Bz(x) - u Cz(x) - E(x)),
    down to claimed evaluations vA, vB, vC, vE at a random point r_x;
  * sum-check 2 over nu = log2(nz) variables, degree 2, down to one
    evaluation of z = (u, X, W) at r_y;
  * the matrices preprocessed into per-row point tables
    H_M[x] = sum_y M[x, y] G_y, so that the verifier computes Com(L) =
    sum_M c_M MSM(eq(r_x, .), H_M) without touching A, B or C;
  * three inner-product arguments over the Pedersen key opening W at r_y
    against comm_W, E at r_x against comm_E and L at r_y against Com(L).

On the device: the sum-check rounds are plain torch over ops/field.py's
add and sub and the mont_mul kernel (the four or three evaluation points of
a round as one stacked call); the IPA never folds its generators: every
round commits L and R by one J = 2 MSM over the key's own prepared bases
(pedersen.py) with the scalars weighted by the products of the challenges
that the fold would have applied (_IPA.prove_weighted), and one mont_mul
updates the weights. Each IPA round reads L and R back to the host for the
transcript. The H tables are built on the host (the native curve helper)
once per pp digest and cached on disk, then scaled onto the device once
per SpartanSystem (setup() prepares them and the key's bases).
"""

from __future__ import annotations

import json
import os
import time
import zipfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import native_ff
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm_pallas as MP
from ..utils import telemetry as T_
from ..utils.config import CONFIG
from . import serial
from .fold import AccumulatorInstance
from .ivc import IVC, IVCProof, check
from .r1cs import DeviceMat, matvec_all, spmv
from .transcript import Transcript

Affine = Optional[Tuple[int, int]]


def _next_pow2(n: int) -> int:
    k = 1
    while k < n:
        k <<= 1
    return k


def _eq_table_host(p: int, rs: Sequence[int]) -> List[int]:
    """eq(r, x) for all x in {0,1}^k; index bit order: rs[0] is the MSB
    (matching the sum-check's arr[:h]/arr[h:] variable binding)."""
    e = [1]
    for r in reversed(list(rs)):
        r = r % p
        lo = [(1 - r) % p * v % p for v in e]
        hi = [r * v % p for v in e]
        e = lo + hi
    return e


def _eq_point_host(p: int, a: Sequence[int], b: Sequence[int]) -> int:
    acc = 1
    for x, y in zip(a, b):
        acc = acc * ((1 - x) * (1 - y) + x * y) % p
    return acc


def _interp_eval(p: int, ys: Sequence[int], r: int) -> int:
    """Evaluate the unique degree-(k-1) poly through (i, ys[i]) at r."""
    k = len(ys)
    total = 0
    for i in range(k):
        num, den = 1, 1
        for j in range(k):
            if j != i:
                num = num * (r - j) % p
                den = den * (i - j) % p
        total = (total + ys[i] * num * pow(den, p - 2, p)) % p
    return total


def _modsum(spec: F.FieldSpec, v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum mod p over `dim` of Montgomery (or canonical) digits: one lazy
    integer sum of the 16-bit halves and one reduction (exact, so the
    order of the sum is free)."""
    return F.from_h16(F.h_reduce_lazy(spec, F.to_h16(v).sum(dim)))


def _pad(arr: torch.Tensor, n: int) -> torch.Tensor:
    if arr.shape[-2] == n:
        return arr
    return torch.nn.functional.pad(arr, (0, 0, 0, n - arr.shape[-2]))


# ---------------------------------------------------------------------------
# Inner-product argument (non-hiding Bulletproofs IPA over the Pedersen key).
# ---------------------------------------------------------------------------


@dataclass
class IPAProof:
    Ls: List[Affine]
    Rs: List[Affine]
    a_final: int

    def to_dict(self) -> dict:
        return {"Ls": serial.enc_points(self.Ls),
                "Rs": serial.enc_points(self.Rs),
                "a_final": int(self.a_final)}

    @staticmethod
    def from_dict(d: dict) -> "IPAProof":
        return IPAProof(Ls=serial.dec_points(d["Ls"]),
                        Rs=serial.dec_points(d["Rs"]),
                        a_final=int(d["a_final"]))


class _IPA:
    """Prover/verifier for <a, b> = v with P = <a, G> committed over the
    key's first n generators G.

    a is secret (committed), b is public. U is an independent generator; the
    claimed value is bound via P' = P + v*(c*U) with a transcript challenge
    c drawn after absorbing (P, v)."""

    def __init__(self, curve: C.CurveSpec, fspec: F.FieldSpec,
                 U_affine: Tuple[int, int], ck):
        self.curve = curve
        self.fspec = fspec
        self.U_affine = U_affine
        self.ck = ck

    def _mont(self, vs: Sequence[int], device) -> torch.Tensor:
        return F.from_ints(self.fspec, vs, device, mont=True)

    def _u_point(self, tr: Transcript, P_aff: Affine, v: int) -> Affine:
        tr.absorb_point(P_aff)
        tr.absorb_scalar(v)
        return C.host_scalar_mul(self.curve, tr.challenge(), self.U_affine)

    def prove(self, tr: Transcript, n: int, a_mont: torch.Tensor,
              b_mont: torch.Tensor, P_aff: Affine, v: int) -> IPAProof:
        return self.prove_weighted(tr, n, a_mont, b_mont, P_aff, v)[0]

    def prove_weighted(self, tr: Transcript, n: int, a_mont: torch.Tensor,
                       b_mont: torch.Tensor, P_aff: Affine, v: int
                       ) -> Tuple[IPAProof, torch.Tensor]:
        """prove, and the final weights w as (n, 32) canonical digits: the
        verifier's folded generator is sum_i w_i G_i.

        The generators are never folded. After k folds to n_k = n / 2^k,
        generator j is G^(k)_j = sum over i = j mod n_k of w_i G_i, w_i the
        product of x_t^-1 (where i mod n_t fell in the low half at round t)
        and x_t (the high half). So each round's L = <a_lo, G_hi> and
        R = <a_hi, G_lo> are one J = 2 MSM over the key's first n prepared
        bases, with the scalar a[(i + h) mod n_k] w_i on the half each
        takes and 0 on the other."""
        cv, fs = self.curve, self.fspec
        p = fs.p
        dev = a_mont.device
        Uc_aff = self._u_point(tr, P_aff, v)
        if n & (n - 1) or a_mont.shape[0] != n or b_mont.shape[0] != n:
            raise ValueError(f"IPA: vectors of {a_mont.shape[0]} and "
                             f"{b_mont.shape[0]} elements, want n = {n}, "
                             "a power of two")
        a, b = a_mont, b_mont
        i = torch.arange(n, device=dev)
        w = F.from_ints(fs, [1], dev).expand(n, F.N_LIMBS)
        Ls: List[Affine] = []
        Rs: List[Affine] = []
        while a.shape[0] > 1:
            nk = a.shape[0]
            h = nk // 2
            cross = _modsum(fs, F.mont_mul(fs, a, torch.cat([b[h:], b[:h]])
                                           ).reshape(2, h, F.N_LIMBS), dim=1)
            j = i & (nk - 1)
            low = (j < h)[:, None]
            # Montgomery a times canonical w: canonical a[j ^ h] w_i.
            t = F.mont_mul(fs, a[j ^ h], w)
            sc = torch.stack([t * ~low,    # L: a_lo over G_hi
                              t * low])    # R: a_hi over G_lo
            pt = self.ck.commit_many(sc, 256)
            cl, cr = F.to_ints(fs, cross, mont=True)
            L_msm, R_msm = C.pt_to_affine_host(cv, pt)
            L_aff = C.host_add(cv, L_msm, C.host_scalar_mul(cv, cl, Uc_aff))
            R_aff = C.host_add(cv, R_msm, C.host_scalar_mul(cv, cr, Uc_aff))
            tr.absorb_point(L_aff)
            tr.absorb_point(R_aff)
            x = tr.challenge()
            xi = pow(x, p - 2, p)
            xm, xim = self._mont([x, xi], dev)
            a = F.add(fs, F.mont_mul(fs, xm, a[:h]),
                      F.mont_mul(fs, xim, a[h:]))
            b = F.add(fs, F.mont_mul(fs, xim, b[:h]),
                      F.mont_mul(fs, xm, b[h:]))
            w = F.mont_mul(fs, w, torch.where(low, xim, xm))
            Ls.append(L_aff)
            Rs.append(R_aff)
            T_.count("spartan/ipa_rounds")
        a_final = F.to_ints(fs, a, mont=True)[0]
        return IPAProof(Ls=Ls, Rs=Rs, a_final=a_final), w

    def verify(self, tr: Transcript, n: int, b_mont: torch.Tensor,
               P_aff: Affine, v: int, proof: IPAProof) -> bool:
        cv, fs = self.curve, self.fspec
        p = fs.p
        dev = b_mont.device
        Uc_aff = self._u_point(tr, P_aff, v)
        k = n.bit_length() - 1
        if len(proof.Ls) != k or len(proof.Rs) != k:
            return False
        b = b_mont
        xs: List[int] = []
        for L_aff, R_aff in zip(proof.Ls, proof.Rs):
            tr.absorb_point(L_aff)
            tr.absorb_point(R_aff)
            x = tr.challenge()
            xi = pow(x, p - 2, p)
            h = b.shape[0] // 2
            xm, xim = self._mont([x, xi], dev)
            b = F.add(fs, F.mont_mul(fs, xim, b[:h]),
                      F.mont_mul(fs, xm, b[h:]))
            xs.append(x)
        b0 = F.to_ints(fs, b, mont=True)[0]
        # Weight vector for the folded generator: w_i = prod_t x_t^{+-1}
        # with xs[t] applied at bit t (MSB first), exponent -1 on the low
        # half (G' = x^-1 G_lo + x G_hi).
        w = [1]
        for x in xs:
            xi = pow(x, p - 2, p)
            w = [u for v_ in w for u in (v_ * xi % p, v_ * x % p)]
        G0_aff = self.ck.affine(self.ck.commit(F.from_ints(fs, w, dev)))[0]

        a0 = proof.a_final % p
        lhs = C.host_add(
            cv, C.host_scalar_mul(cv, a0, G0_aff),
            C.host_scalar_mul(cv, a0 * b0 % p, Uc_aff))
        rhs = C.host_add(cv, P_aff, C.host_scalar_mul(cv, v % p, Uc_aff))
        for x, L_aff, R_aff in zip(xs, proof.Ls, proof.Rs):
            x2 = x * x % p
            xi2 = pow(x2, p - 2, p)
            rhs = C.host_add(cv, rhs, C.host_scalar_mul(cv, x2, L_aff))
            rhs = C.host_add(cv, rhs, C.host_scalar_mul(cv, xi2, R_aff))
        return lhs == rhs


# ---------------------------------------------------------------------------
# The compressed proof object.
# ---------------------------------------------------------------------------


@dataclass
class SpartanProof:
    sc1_evals: List[List[int]]   # per round, g(0..3)
    vA: int
    vB: int
    vC: int
    vE: int
    sc2_evals: List[List[int]]   # per round, h(0..2)
    vL: int                      # L~(r_y), opened against Com(L)
    ipa_W: IPAProof
    ipa_E: IPAProof
    ipa_L: IPAProof

    def to_dict(self) -> dict:
        return {
            "sc1_evals": [serial.enc_ints(e) for e in self.sc1_evals],
            "vA": int(self.vA), "vB": int(self.vB),
            "vC": int(self.vC), "vE": int(self.vE),
            "sc2_evals": [serial.enc_ints(e) for e in self.sc2_evals],
            "vL": int(self.vL),
            "ipa_W": self.ipa_W.to_dict(),
            "ipa_E": self.ipa_E.to_dict(),
            "ipa_L": self.ipa_L.to_dict(),
        }

    @staticmethod
    def from_dict(d: dict) -> "SpartanProof":
        return SpartanProof(
            sc1_evals=[serial.enc_ints(e) for e in d["sc1_evals"]],
            vA=int(d["vA"]), vB=int(d["vB"]),
            vC=int(d["vC"]), vE=int(d["vE"]),
            sc2_evals=[serial.enc_ints(e) for e in d["sc2_evals"]],
            vL=int(d["vL"]),
            ipa_W=IPAProof.from_dict(d["ipa_W"]),
            ipa_E=IPAProof.from_dict(d["ipa_E"]),
            ipa_L=IPAProof.from_dict(d["ipa_L"]))


@dataclass
class CompressedProof:
    """IVC chain claims (per-step instances) + Spartan argument; the
    accumulator witness vectors are NOT shipped (chain.final_W/E empty)."""

    chain: IVCProof
    spartan: SpartanProof

    @property
    def num_steps(self) -> int:
        return self.chain.num_steps

    def to_dict(self) -> dict:
        return {"chain": self.chain.to_dict(),
                "spartan": self.spartan.to_dict()}

    def save(self, path: str) -> None:
        serial.dump("compressed_proof", self.to_dict(), path)

    @staticmethod
    def from_dict(d: dict) -> "CompressedProof":
        return CompressedProof(chain=IVCProof.from_dict(d["chain"]),
                               spartan=SpartanProof.from_dict(d["spartan"]))

    @staticmethod
    def load(path: str) -> "CompressedProof":
        return CompressedProof.from_dict(serial.load("compressed_proof",
                                                     path))


# ---------------------------------------------------------------------------
# The preprocessed matrix tables.
# ---------------------------------------------------------------------------


def _h_cache_path(curve: C.CurveSpec, m: int, pp_digest: int) -> str:
    return os.path.join(CONFIG.cache_dir,
                        f"torch_spartanH_{curve.name}_{m}_{pp_digest:064x}"
                        ".npz")


def _h_meta(curve: C.CurveSpec, m: int, pp_digest: int) -> dict:
    return {"pp_digest": f"{pp_digest:064x}", "m": m, "curve": curve.name,
            "shapes": {"x": [3, m, F.N_LIMBS], "y": [3, m, F.N_LIMBS],
                       "inf": [3, m]}}


def _load_h_cache(path: str, want: dict):
    """(x, y, inf) of a cached table file, or None if it is missing or
    disagrees with `want` (digest, m, curve, array shapes) in any way."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrs = (z["x"], z["y"], z["inf"])
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None
    shapes = {k: list(a.shape) for k, a in zip(("x", "y", "inf"), arrs)}
    if meta != want or shapes != want["shapes"]:
        return None
    return arrs


class SpartanSystem:
    """Succinct argument for ONE relaxed R1CS claim over (shape, ck), on
    the shape's device.

    Two entry levels: prove_relaxed/verify_relaxed work on a bare
    (instance, witness) pair (the recursive SNARK compresses its final
    instances through them); compress/verify wrap an IVCProof (replay the
    chain's instance folds, then prove the folded claim)."""

    def __init__(self, ivc: Optional[IVC] = None, shape=None, curve=None,
                 ck=None, pp_digest: Optional[int] = None):
        self.ivc = ivc
        if ivc is not None:
            shape, curve, ck = ivc.shape, ivc.curve, ivc.ck
            pp_digest = ivc.pp_digest
        self.shape = shape
        self.ck = ck
        self.pp_digest = pp_digest
        self.fspec = shape.field
        self.curve = curve
        self.device = shape.device
        self.m = _next_pow2(shape.n_cons)          # sum-check 1 domain
        self.nz = _next_pow2(shape.n_vars)         # sum-check 2 domain
        self.n_ipa_w = _next_pow2(shape.n_wit)
        self.n_ipa_e = self.m
        need = max(self.n_ipa_w, self.n_ipa_e, self.nz)
        if ck.n < need:
            raise ValueError(
                f"commitment key too small for Spartan's IPAs: has {ck.n} "
                f"generators, needs {need} = max(n_ipa_w {self.n_ipa_w}, "
                f"m {self.m}, nz {self.nz}) (create the key with a "
                "power-of-two size >= max(n_wit, n_cons, n_vars))")
        self._H = None         # host tables (x, y, inf)
        self._H_bases = None   # their MSM layout on the device
        # Transposed matrices: L[y] = sum_x eq_rx[x] M[x, y] as an SpMV.
        self.matT = [DeviceMat(rows=d.cols, cols=d.rows, vals=d.vals,
                               n_cons=shape.n_vars)
                     for d in (shape.dev[k] for k in ("A", "B", "C"))]
        (ux, uy), = C.derive_generators(self.curve, b"spartan-ipa-u", 1)
        self.ipa = _IPA(self.curve, self.fspec, (ux, uy), ck)
        self.timings: Dict[str, float] = {}   # seconds of the last prove

    # -- setup preprocessing ------------------------------------------------
    def preprocess_H(self):
        """Per-row matrix point tables H_M[x] = sum_y M[x, y] G_y for M in
        (A, B, C), padded to m rows with the identity: host (x, y, inf)
        arrays, x and y Montgomery digits (3, m, 32), inf (3, m). Built on
        the host through the native curve helper and cached on disk as
        .cache/torch_spartanH_{curve}_{m}_{pp digest hex}.npz with the full
        digest, m, the curve and the shapes, each checked on load: a file
        that disagrees is rebuilt, never trusted (the pp digest binds the
        matrices and the generators)."""
        if self._H is not None:
            return self._H
        cv, m = self.curve, self.m
        path = _h_cache_path(cv, m, self.pp_digest)
        want = _h_meta(cv, m, self.pp_digest)
        got = _load_h_cache(path, want)
        if got is not None:
            T_.count("spartan/h_loads")
        else:
            if os.path.exists(path):
                T_.count("spartan/h_refused")
            got = self._build_H()
            T_.count("spartan/h_builds")
            os.makedirs(CONFIG.cache_dir, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp.npz"
            np.savez(tmp, x=got[0], y=got[1], inf=got[2],
                     meta=np.asarray(json.dumps(want)))
            os.replace(tmp, path)
        self._H = got
        return got

    def _build_H(self):
        fs, cv = self.fspec, self.curve
        fb = cv.base
        rinv_s = pow(fs.r_mod_p, fs.p - 2, fs.p)
        rinv_b = pow(fb.r_mod_p, fb.p - 2, fb.p)
        g = self.ck.gens_affine[: self.shape.n_vars]
        gens = [(int(x) * rinv_b % fb.p, int(y) * rinv_b % fb.p)
                for x, y in zip(fb.limbs_to_ints(g[:, 0]),
                                fb.limbs_to_ints(g[:, 1]))]
        use_native = native_ff.available()
        xs = np.zeros((3, self.m, F.N_LIMBS), np.uint8)
        ys = np.zeros((3, self.m, F.N_LIMBS), np.uint8)
        inf = np.ones((3, self.m), bool)
        for mi, mat in enumerate((self.shape.A, self.shape.B, self.shape.C)):
            H: dict = {}
            vals = fs.limbs_to_ints(mat.vals_mont)
            for k in range(len(mat.rows)):
                r_, c_ = int(mat.rows[k]), int(mat.cols[k])
                v_ = int(vals[k]) * rinv_s % fs.p
                if use_native:
                    H[r_] = native_ff.fold_point(cv, H.get(r_), gens[c_], v_)
                else:
                    H[r_] = C.host_add(cv, H.get(r_),
                                       C.host_scalar_mul(cv, v_, gens[c_]))
            for r_, pt in H.items():
                if pt is None:
                    continue
                inf[mi, r_] = False
                xs[mi, r_] = F.int_to_limbs(fb.to_mont_int(pt[0]))
                ys[mi, r_] = F.int_to_limbs(fb.to_mont_int(pt[1]))
        return xs, ys, inf

    def H_bases(self):
        """The three tables as one MSM base array of 3m points on the
        device (ops/msm_pallas.var_bases: scale16, to_affine), made once;
        identity rows are masked there."""
        if self._H_bases is None:
            xs, ys, inf = self.preprocess_H()
            fb, dev = self.curve.base, self.device
            one = torch.from_numpy(fb.one_mont_limbs).to(dev)
            live = torch.from_numpy(~inf.reshape(-1)).to(dev)[:, None]
            x = torch.from_numpy(xs.reshape(-1, F.N_LIMBS).astype(
                np.int32)).to(dev)
            y = torch.from_numpy(ys.reshape(-1, F.N_LIMBS).astype(
                np.int32)).to(dev)
            zero = torch.zeros_like(x)
            pts = MP.point_words((x, torch.where(live, y, one),
                                  torch.where(live, one, zero)))
            self._H_bases = MP.var_bases(self.curve, pts, 256)
        return self._H_bases

    def setup(self) -> None:
        """Prepare on the device what compress and verify read: the tables'
        bases and the key's prepared bases at each IPA length (the largest
        first, so the others are its prefixes). scale16 and to_affine run
        here and in no later compress or verify."""
        self.H_bases()
        for n in sorted({self.nz, self.n_ipa_w, self.n_ipa_e}, reverse=True):
            self.ck.bases_lm(n, 256)

    def _com_L(self, eq_rx: List[int], cA: int, cB: int, cC: int) -> Affine:
        """Verifier-side commitment to the L vector, computed WITHOUT the
        matrices: Com(L) = sum_M c_M MSM(eq_rx, H_M), as one MSM over the
        three tables with the scalars c_M eq_rx[x] (the same group
        element)."""
        fs, dev = self.fspec, self.device
        bases = self.H_bases()
        eq = F.from_ints(fs, eq_rx, dev)
        c = F.from_ints(fs, [cA, cB, cC], dev, mont=True)
        sc = F.mont_mul(fs, c[:, None], eq[None])   # canonical c_M eq[x]
        pt = MP.msm_var(self.curve, sc.reshape(1, 3 * self.m, F.N_LIMBS),
                        bases, 256)
        return C.pt_to_affine_host(self.curve, pt)[0]

    # -- shared helpers -----------------------------------------------------
    def _eq_dev(self, rs: Sequence[int]) -> torch.Tensor:
        return F.to_mont(self.fspec, F.from_ints(
            self.fspec, _eq_table_host(self.fspec.p, rs), self.device))

    def _transcript(self, inst: AccumulatorInstance) -> Transcript:
        tr = Transcript(self.fspec.name, b"spartan", self.pp_digest)
        tr.absorb_scalar(inst.u)
        tr.absorb_scalars(inst.X)
        tr.absorb_point(inst.comm_W)
        tr.absorb_point(inst.comm_E)
        return tr

    def _round(self, arrs: torch.Tensor, points: int) -> torch.Tensor:
        """A sum-check round's arrays (k, size, 32) at t = 0 .. points-1:
        (points, k, size/2, 32), the low half, the high half, then one more
        difference each."""
        fs = self.fspec
        h = arrs.shape[1] // 2
        lo, hi = arrs[:, :h], arrs[:, h:]
        d = F.sub(fs, hi, lo)
        ts = [lo, hi]
        while len(ts) < points:
            ts.append(F.add(fs, ts[-1], d))
        return torch.stack(ts)

    def _bind(self, arrs: torch.Tensor, r: int) -> torch.Tensor:
        """Fix the round's variable to r: x_lo + r (x_hi - x_lo)."""
        fs = self.fspec
        h = arrs.shape[1] // 2
        lo = arrs[:, :h]
        rm = F.from_ints(fs, [r], self.device, mont=True)[0]
        return F.add(fs, lo, F.mont_mul(fs, rm, F.sub(fs, arrs[:, h:], lo)))

    def _L_vector(self, eq_rx_mont: torch.Tensor, cA: int, cB: int,
                  cC: int) -> torch.Tensor:
        """L = cA A^T eq + cB B^T eq + cC C^T eq, (n_vars, 32) Montgomery."""
        fs = self.fspec
        parts = torch.stack([spmv(fs, mt, eq_rx_mont) for mt in self.matT])
        c = F.from_ints(fs, [cA, cB, cC], self.device, mont=True)
        return _modsum(fs, F.mont_mul(fs, c[:, None], parts))

    # -- prove --------------------------------------------------------------
    def compress(self, proof: IVCProof, io_arity: int) -> CompressedProof:
        """Compress an IVCProof: replay the instance folding, then prove the
        folded claim. The returned proof drops final_W/final_E."""
        inst = self.ivc.fold_instances_only(proof, io_arity)
        spartan = self.prove_relaxed(inst, proof.final_W, proof.final_E)
        chain = IVCProof(z0=list(proof.z0), steps=list(proof.steps),
                         comm_Ts=list(proof.comm_Ts), final_W=[],
                         final_E=[], pp_digest=proof.pp_digest)
        return CompressedProof(chain=chain, spartan=spartan)

    def prove_relaxed(self, inst: AccumulatorInstance, final_W, final_E
                      ) -> SpartanProof:
        """Succinct argument that (inst, W, E) satisfies the relaxed R1CS:
        the witness vectors are consumed here and NOT shipped. The seconds
        of its parts are left in self.timings."""
        fs, shape, dev = self.fspec, self.shape, self.device
        p = fs.p
        u, X = inst.u, list(inst.X)
        self.timings = {}
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            t = time.perf_counter()
            self.timings[name] = t - t0
            t0 = t

        z_mont = F.to_mont(fs, F.from_ints(fs, [u] + X + list(final_W),
                                           dev))
        az, bz, cz = matvec_all(shape, z_mont)
        e_mont = F.to_mont(fs, F.from_ints(fs, list(final_E), dev))
        e_pad = _pad(e_mont, self.m)
        u_mont = F.from_ints(fs, [u], dev, mont=True)[0]

        tr = self._transcript(inst)
        s = self.m.bit_length() - 1
        taus = [tr.challenge() for _ in range(s)]
        arrs = torch.stack([self._eq_dev(taus)] + [
            _pad(x, self.m) for x in (az, bz, cz, e_mont)])

        sc1_evals: List[List[int]] = []
        rs_x: List[int] = []
        while arrs.shape[1] > 1:
            eq_t, az_t, bz_t, cz_t, e_t = self._round(arrs, 4).unbind(1)
            inner = F.sub(fs, F.mont_mul(fs, az_t, bz_t),
                          F.add(fs, F.mont_mul(fs, u_mont, cz_t), e_t))
            ev = F.to_ints(fs, _modsum(fs, F.mont_mul(fs, eq_t, inner),
                                       dim=1), mont=True)
            sc1_evals.append(ev)
            tr.absorb_scalars(ev)
            r = tr.challenge()
            rs_x.append(r)
            arrs = self._bind(arrs, r)
        vA, vB, vC, vE = F.to_ints(fs, arrs[1:, 0], mont=True)
        tr.absorb_scalars([vA, vB, vC, vE])
        cA, cB, cC = tr.challenge(), tr.challenge(), tr.challenge()
        lap("sumcheck1")

        eq_rx = self._eq_dev(rs_x)
        L0 = _pad(self._L_vector(eq_rx, cA, cB, cC), self.nz)
        arrs = torch.stack([L0, _pad(z_mont, self.nz)])
        sc2_evals: List[List[int]] = []
        rs_y: List[int] = []
        while arrs.shape[1] > 1:
            t = self._round(arrs, 3)
            ev = F.to_ints(fs, _modsum(fs, F.mont_mul(fs, t[:, 0], t[:, 1]),
                                       dim=1), mont=True)
            sc2_evals.append(ev)
            tr.absorb_scalars(ev)
            r = tr.challenge()
            rs_y.append(r)
            arrs = self._bind(arrs, r)
        lap("sumcheck2")

        # Openings.
        eq_y = _eq_table_host(p, rs_y)
        vL, vz = F.to_ints(fs, arrs[:, 0], mont=True)
        pub = (u * eq_y[0] + sum(
            x * eq_y[1 + i] for i, x in enumerate(X))) % p
        w_claim = (vz - pub) % p

        # L opening: vL = L~(r_y) (the fully folded L), proven against the
        # verifier-computed Com(L) so verification never touches A/B/C.
        tr.absorb_scalar(vL)
        comL = self.ck.affine(self.ck.commit(F.from_mont(fs, L0), 256))[0]
        eq_ry_mont = F.to_mont(fs, F.from_ints(fs, eq_y, dev))
        ipa_L = self.ipa.prove(tr, self.nz, L0, eq_ry_mont, comL, vL)
        lap("ipa_L")

        n_io = shape.n_io
        W_mont = F.to_mont(fs, F.from_ints(fs, list(final_W), dev))
        b_w = _pad(eq_ry_mont[1 + n_io: 1 + n_io + shape.n_wit],
                   self.n_ipa_w)
        ipa_W = self.ipa.prove(tr, self.n_ipa_w, _pad(W_mont, self.n_ipa_w),
                               b_w, inst.comm_W, w_claim)
        lap("ipa_W")

        ipa_E = self.ipa.prove(tr, self.n_ipa_e, _pad(e_mont, self.n_ipa_e),
                               eq_rx, inst.comm_E, vE)
        lap("ipa_E")

        return SpartanProof(
            sc1_evals=sc1_evals, vA=vA, vB=vB, vC=vC, vE=vE,
            sc2_evals=sc2_evals, vL=vL, ipa_W=ipa_W, ipa_E=ipa_E,
            ipa_L=ipa_L)

    # -- verify -------------------------------------------------------------
    def verify(self, cp: CompressedProof, io_arity: int) -> List[int]:
        """Full verification of a compressed proof; returns z_final."""
        inst = self.ivc.fold_instances_only(cp.chain, io_arity)
        self.verify_relaxed(inst, cp.spartan)
        return cp.chain.steps[-1].X[:io_arity]

    def verify_relaxed(self, inst: AccumulatorInstance,
                       sp: SpartanProof) -> None:
        """Verify a Spartan argument against a relaxed instance; raises
        AssertionError on failure. Never reads the matrices: Com(L) comes
        from the preprocessed tables."""
        fs, shape, dev = self.fspec, self.shape, self.device
        p = fs.p
        u, X = inst.u, list(inst.X)

        tr = self._transcript(inst)
        s = self.m.bit_length() - 1
        nu = self.nz.bit_length() - 1
        check(len(sp.sc1_evals) == s, "sum-check 1 round count")
        check(len(sp.sc2_evals) == nu, "sum-check 2 round count")
        taus = [tr.challenge() for _ in range(s)]

        claim = 0
        rs_x: List[int] = []
        for ev in sp.sc1_evals:
            check(len(ev) == 4, "sc1 round must have 4 evaluations")
            check((ev[0] + ev[1]) % p == claim % p, "sum-check 1 failed")
            tr.absorb_scalars([v % p for v in ev])
            r = tr.challenge()
            rs_x.append(r)
            claim = _interp_eval(p, [v % p for v in ev], r)
        eq_tr = _eq_point_host(p, [t % p for t in taus],
                               [r % p for r in rs_x])
        want = eq_tr * ((sp.vA * sp.vB - u * sp.vC - sp.vE) % p) % p
        check(claim % p == want, "sum-check 1 final claim mismatch")

        tr.absorb_scalars([sp.vA, sp.vB, sp.vC, sp.vE])
        cA, cB, cC = tr.challenge(), tr.challenge(), tr.challenge()
        claim2 = (cA * sp.vA + cB * sp.vB + cC * sp.vC) % p

        rs_y: List[int] = []
        for ev in sp.sc2_evals:
            check(len(ev) == 3, "sc2 round must have 3 evaluations")
            check((ev[0] + ev[1]) % p == claim2 % p, "sum-check 2 failed")
            tr.absorb_scalars([v % p for v in ev])
            r = tr.challenge()
            rs_y.append(r)
            claim2 = _interp_eval(p, [v % p for v in ev], r)

        # vL = L~(r_y): prover-supplied, proven by an IPA against Com(L),
        # which the verifier computes from the PREPROCESSED per-row point
        # tables; the sparse matrices are never touched at verify time.
        eq_rx_host = _eq_table_host(p, rs_x)
        eq_ry_host = _eq_table_host(p, rs_y)
        eq_ry = F.to_mont(fs, F.from_ints(fs, eq_ry_host, dev))
        vL = sp.vL % p
        check(vL != 0, "degenerate evaluation point (vL == 0)")
        tr.absorb_scalar(vL)
        comL = self._com_L(eq_rx_host, cA, cB, cC)
        check(self.ipa.verify(tr, self.nz, eq_ry, comL, vL, sp.ipa_L),
              "IPA opening of L failed")
        vz = claim2 * pow(vL, p - 2, p) % p
        pub = (u * eq_ry_host[0] + sum(
            x * eq_ry_host[1 + i] for i, x in enumerate(X))) % p
        w_claim = (vz - pub) % p

        n_io = shape.n_io
        b_w = _pad(eq_ry[1 + n_io: 1 + n_io + shape.n_wit], self.n_ipa_w)
        check(self.ipa.verify(tr, self.n_ipa_w, b_w, inst.comm_W, w_claim,
                              sp.ipa_W), "IPA opening of W failed")

        eq_rx = F.to_mont(fs, F.from_ints(fs, eq_rx_host, dev))
        check(self.ipa.verify(tr, self.n_ipa_e, eq_rx, inst.comm_E, sp.vE,
                              sp.ipa_E), "IPA opening of E failed")
