"""Pedersen vector commitments (port of hotproofs_tpu/nova/pedersen.py).

Keys are the reference's deterministic generator vectors (same derivation),
cached as the port's own `.cache/torch_gens_*.npy`. Commit(v) = sum_i v_i G_i
through the MSM chain of ops/msm_pallas.py over bases pre-scaled by 16^w:
`scaled_affine` doubles the generators (the scale16 kernel on the card, its
plain version on the CPU) and converts them to affine with the to_affine
kernel, once per key prefix; the result is cached on disk under the port's
own `torch_scaledaff_*` names.
The kernel layouts of those bases (time-major, and the lane-major copy the
bucket kernel reads) are made once per key prefix and kept on the key.

Witness vectors carry a static small/large split: the few full-width
positions (big_idx) commit at 256 bits, everything else at SMALL_BITS.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dc_field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm_pallas as MP
from ..utils.config import CONFIG

SMALL_BITS = 40  # witness values are bits / u32 words / u34 sums


def _load_or_derive(spec: C.CurveSpec, label: bytes, n: int) -> np.ndarray:
    """(n, 2, 32) Montgomery affine generator digits (cached on disk, written
    through a per-process temporary name)."""
    os.makedirs(CONFIG.cache_dir, exist_ok=True)
    path = os.path.join(CONFIG.cache_dir,
                        f"torch_gens_{spec.name}_{label.decode()}_{n}.npy")
    if os.path.exists(path):
        return np.load(path)
    limbs = np.zeros((n, 2, F.N_LIMBS), np.int32)
    for i, (x, y) in enumerate(C.derive_generators(spec, label, n)):
        limbs[i, 0] = F.int_to_limbs(spec.base.to_mont_int(x))
        limbs[i, 1] = F.int_to_limbs(spec.base.to_mont_int(y))
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, limbs)
    os.replace(tmp, path)
    return limbs


@dataclass
class CommitmentKey:
    spec: C.CurveSpec
    n: int
    gens_affine: np.ndarray  # (n, 2, 32) Montgomery affine digits
    label: bytes = b""
    device: torch.device = torch.device("cpu")
    _scaled: Dict = dc_field(default_factory=dict, repr=False)
    _bases: Dict = dc_field(default_factory=dict, repr=False)

    @staticmethod
    def create(spec: C.CurveSpec, label: bytes, n: int,
               device="cpu") -> "CommitmentKey":
        return CommitmentKey(spec, n, _load_or_derive(spec, label, n), label,
                             torch.device(device))

    @property
    def points(self) -> C.Point:
        """The generators as projective Montgomery (n, 32) x3 tensors."""
        g = torch.from_numpy(self.gens_affine).to(self.device)
        one = torch.from_numpy(self.spec.base.one_mont_limbs).to(self.device)
        return (g[:, 0], g[:, 1], one.expand(self.n, F.N_LIMBS))

    # -- key preparation -----------------------------------------------------
    def scaled_affine(self, m: int, max_bits: int) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
        """(W4, m, 32) affine Montgomery x, y of 16^w * G_j, j < m."""
        w4 = MP.n_windows4(max_bits)
        for (mm, ww), (xa, ya) in self._scaled.items():
            if mm >= m and ww >= w4:
                return xa[:w4, :m], ya[:w4, :m]
        disk = os.path.join(
            CONFIG.cache_dir, f"torch_scaledaff_{self.spec.name}_"
            f"{self.label.decode()}_{m}_{w4}.npy") if self.label else None
        if disk and os.path.exists(disk):
            arr = torch.from_numpy(np.load(disk).astype(np.int32))
            xa, ya = arr[0].to(self.device), arr[1].to(self.device)
        else:
            pts = tuple(c[:m] for c in self.points)
            xa, ya = MP.to_affine(self.spec,
                                  *MP.scale_points16(self.spec, pts, w4))
            if disk:
                os.makedirs(CONFIG.cache_dir, exist_ok=True)
                tmp = f"{disk}.{os.getpid()}.tmp.npy"
                np.save(tmp, torch.stack([xa, ya]).cpu().numpy().astype(
                    np.uint8))
                os.replace(tmp, disk)
        self._scaled[(m, w4)] = (xa, ya)
        return xa, ya

    def bases(self, m: int, max_bits: int) -> torch.Tensor:
        """MSM kernel layout of the first m pre-scaled generators."""
        key = (m, MP.n_windows4(max_bits))
        if key not in self._bases:
            self._bases[key] = MP.bases_tm(*self.scaled_affine(m, max_bits),
                                           m, max_bits)
        return self._bases[key]

    def bases_lm(self, m: int, max_bits: int) -> torch.Tensor:
        """The bucket kernel's lane-major copy of bases(m, max_bits)."""
        return self._lane_major((m, MP.n_windows4(max_bits)),
                                self.bases(m, max_bits))

    def _lane_major(self, key, bases: torch.Tensor) -> torch.Tensor:
        if ("lm",) + key not in self._bases:
            self._bases[("lm",) + key] = MP.lane_major(bases)
        return self._bases[("lm",) + key]

    def bases_big(self, big_idx: np.ndarray) -> torch.Tensor:
        """MSM kernel layout of the full-width positions' generators."""
        key = ("big",) + tuple(int(v) for v in big_idx)
        if key not in self._bases:
            xa, ya = self.scaled_affine(int(max(big_idx)) + 1, 256)
            idx = torch.as_tensor(np.asarray(big_idx, np.int64),
                                  device=self.device)
            self._bases[key] = MP.bases_tm(xa[:, idx], ya[:, idx],
                                           len(big_idx), 256)
        return self._bases[key]

    def bases_big_lm(self, big_idx: np.ndarray) -> torch.Tensor:
        """The bucket kernel's lane-major copy of bases_big(big_idx)."""
        return self._lane_major(("big",) + tuple(int(v) for v in big_idx),
                                self.bases_big(big_idx))

    # -- commitments ----------------------------------------------------------
    def commit_many(self, scalars: torch.Tensor,
                    max_bits: int = 256) -> C.Point:
        """J commitments of (J, m, 32) canonical scalars over one key
        prefix: projective Montgomery (J, 32) x3."""
        m = scalars.shape[1]
        return MP.msm_many(self.spec, scalars, self.bases(m, max_bits), m,
                           max_bits, bases_lm=self.bases_lm(m, max_bits))

    def commit(self, scalars: torch.Tensor, max_bits: int = 256) -> C.Point:
        """One commitment of (m, 32) canonical scalars: (32,) x3."""
        return tuple(c[0] for c in self.commit_many(scalars[None], max_bits))

    def commit_many_split(self, scalars: torch.Tensor,
                          big_idx: np.ndarray) -> C.Point:
        """commit_many with the small/large split: positions in big_idx at
        full width, all others at SMALL_BITS (which they must fit)."""
        m = scalars.shape[1]
        big = torch.as_tensor(np.asarray(big_idx, np.int64),
                              device=scalars.device)
        small = scalars.clone()
        small[:, big] = 0
        if bool((small[..., SMALL_BITS // F.LIMB_BITS:] != 0).any()):
            raise ValueError(f"witness value >= 2^{SMALL_BITS} outside "
                             "big_idx (would truncate in the small MSM)")
        acc = MP.msm_many(self.spec, small, self.bases(m, SMALL_BITS), m,
                          SMALL_BITS, bases_lm=self.bases_lm(m, SMALL_BITS))
        if len(big_idx) == 0:
            return acc
        accb = MP.msm_many(self.spec, scalars[:, big].contiguous(),
                           self.bases_big(big_idx), len(big_idx), 256,
                           bases_lm=self.bases_big_lm(big_idx))
        return C.pt_add(self.spec, acc, accb)

    def commit_many_mesh(self, scalars: torch.Tensor, mesh,
                         max_bits: int = 256, axis: str = "chain",
                         big_idx: Optional[np.ndarray] = None) -> C.Point:
        """commit_many (commit_many_split with big_idx) with the J jobs
        split over a mesh axis (parallel/mesh.py): rank r commits the
        contiguous block [r J/D, (r+1) J/D) against the key's prepared
        bases, which every rank holds, and an all-gather gives every rank
        all J points (proof assembly needs them), (J, 32) x3 in job
        order. J must divide by the axis size D."""
        from ..parallel import mesh as M
        J, D = scalars.shape[0], mesh.get_group(axis).size()
        if J % D:
            raise AssertionError(
                f"jobs {J} must divide by mesh axis {axis}={D}")
        blk, r = J // D, mesh.get_local_rank(axis)
        part = scalars[r * blk:(r + 1) * blk]
        pt = self.commit_many(part, max_bits) if big_idx is None \
            else self.commit_many_split(part, big_idx)
        g = M.gather_points(pt, mesh, axis)             # (D, 3, blk, 32)
        return tuple(g[:, c].reshape(J, F.N_LIMBS) for c in range(3))

    def affine(self, pt: C.Point) -> list:
        """Projective Montgomery (J, 32) x3 -> J affine int pairs."""
        return C.pt_to_affine_host(self.spec, pt)
