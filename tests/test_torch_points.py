"""The variable-base point operations (ops/curve.py pt_scalar_mul,
ops/msm_pallas.py scale16 and msm_var, which Spartan's matrix tables use,
each through its plain version on the CPU) against the host oracles."""

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import msm_pallas as MP

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _points(spec, rng, n, identity=()):
    pts = [C.host_scalar_mul(spec, 1 + int(rng.integers(1 << 62)), spec.gen)
           for _ in range(n)]
    for i in identity:
        pts[i] = None
    return pts


def _scalars(spec, rng, n, bits=256):
    f = spec.scalar
    return [int.from_bytes(rng.bytes(32), "little") % (1 << bits) % f.p
            for _ in range(n)]


@pytest.mark.parametrize("name", ["pallas", "bn254"])
def test_pt_scalar_mul_vs_host(name):
    """The plain double-and-add equals host_scalar_mul, with the scalars 0,
    1 and p - 1, a wide one, and an identity point."""
    spec = C.CURVES[name]
    rng = np.random.default_rng(1)
    pts = _points(spec, rng, 6, identity=(4,))
    ks = [0, 1, spec.scalar.p - 1, 5, 1 << 200] + _scalars(spec, rng, 1)
    got = C.pt_to_affine_host(spec, C.pt_scalar_mul(
        spec, torch.from_numpy(spec.scalar.batch_to_limbs(ks)),
        C.affine_to_mont(spec, pts)))
    assert got == [C.host_scalar_mul(spec, k, p) for k, p in zip(ks, pts)]


def test_scale_points16_keeps_its_digit_interface():
    """scale_points16 (digits, through scale16) == 16^w P on the host."""
    spec = C.PALLAS
    pts = _points(spec, np.random.default_rng(3), 3, identity=(1,))
    got = MP.scale_points16(spec, C.affine_to_mont(spec, pts), 4)
    assert all(c.shape == (4, 3, 32) for c in got)
    aff = C.pt_to_affine_host(spec, tuple(c.reshape(-1, 32) for c in got))
    assert aff == [C.host_scalar_mul(spec, 16 ** w, p)
                   for w in range(4) for p in pts]


@pytest.mark.parametrize("w4", [1, 3])
@pytest.mark.parametrize("name", ["pallas", "vesta", "bn254", "grumpkin"])
def test_scale16_vs_scaled_affine_host(name, w4):
    """scale16 (its plain version on the CPU: Jacobian doublings, stored
    homogeneous) on points of Z != 1 == scaled_affine_host's 16^w P as
    affine Montgomery digits; the identity comes out (0 : 1 : 0) at every
    window."""
    spec = C.CURVES[name]
    f = spec.base
    rng = np.random.default_rng(len(name) + w4)
    pts = _points(spec, rng, 4, identity=(2,))
    X, Y, Z = C.affine_to_mont(spec, pts)
    lam = torch.from_numpy(f.batch_to_limbs(
        [f.to_mont_int(int(k)) for k in rng.integers(2, 1 << 60, 4)]))
    P = MP.point_words(tuple(F.mont_mul(f, c, lam) for c in (X, Y, Z)))
    got = MP.scale16(spec, P, w4)
    assert got.shape == (w4, 4, 3, 8)
    one = F.digits_to_words(torch.from_numpy(f.one_mont_limbs))
    assert torch.equal(got[:, 2, 1], one.expand(w4, 8))
    assert not bool(got[:, 2, 0].any()) and not bool(got[:, 2, 2].any())
    live = [i for i, p in enumerate(pts) if p is not None]
    xa, ya = MP.scaled_affine_host(spec, [pts[i] for i in live], w4)
    w = got[:, live].reshape(-1, 3, 8)
    x, y = MP.to_affine_words_plain(spec, w[:, 0], w[:, 1], w[:, 2])
    assert np.array_equal(F.words_to_digits(x).numpy(), xa.reshape(-1, 32))
    assert np.array_equal(F.words_to_digits(y).numpy(), ya.reshape(-1, 32))


@pytest.mark.parametrize("m", list(range(1, 17)))
def test_msm_var_vs_host(m):
    """msm_var (scale16, to_affine, bases_tm, the MSM chain) on m points,
    one of them the identity, two jobs == host_msm: every m up to the
    plan's smallest B, and beyond it (a small table's sizes). Full 256-bit scalars at m = 1, 2, 4, 8 and 16; 32 bits (8 windows)
    at the others, where 64 windows cost the plain doublings seconds."""
    spec = C.PALLAS
    rng = np.random.default_rng(100 + m)
    bits = 256 if m & (m - 1) == 0 else 32
    pts = _points(spec, rng, m, identity=(m // 2,))
    ks = [_scalars(spec, rng, m, bits) for _ in range(2)]
    assert MP.plan(m, bits)[0] == 8
    sc = torch.from_numpy(np.stack([spec.scalar.batch_to_limbs(k)
                                    for k in ks]))
    kept = MP.var_bases(spec, MP.point_words(C.affine_to_mont(spec, pts)),
                        bits)
    got = C.pt_to_affine_host(spec, MP.msm_var(spec, sc, kept, bits))
    assert got == [C.host_msm(spec, k, pts) for k in ks]


def test_msm_var_reuses_kept_bases():
    """One var_bases result serves two msm_var calls with other scalars
    and gives the host's sums each time; an all-identity base set sums to
    the identity."""
    spec = C.PALLAS
    rng = np.random.default_rng(4)
    pts = _points(spec, rng, 5)
    P = MP.point_words(C.affine_to_mont(spec, pts))
    kept = MP.var_bases(spec, P, 16)
    for _ in range(2):
        ks = _scalars(spec, rng, 5, 16)
        sc = torch.from_numpy(spec.scalar.batch_to_limbs(ks))[None]
        got = C.pt_to_affine_host(spec, MP.msm_var(spec, sc, kept, 16))
        assert got == [C.host_msm(spec, ks, pts)]
    none = MP.point_words(C.affine_to_mont(spec, [None] * 5))
    assert C.pt_to_affine_host(spec, MP.msm_var(
        spec, sc, MP.var_bases(spec, none, 16), 16)) == [None]
