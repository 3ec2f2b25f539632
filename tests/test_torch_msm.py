"""Port MSM chain (plain versions of the bucket, merge and wsum kernels)
and key preparation (plain version of to_affine) vs the reference: the host
oracle host_msm, scaled_affine_host, and scaled_affine_device / the Pallas
MSM in interpret mode. MSM results compare as affine points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotproofs_tpu.ops import curve as RC
from hotproofs_tpu.ops import field as RF
from hotproofs_tpu.ops import msm as RM
from hotproofs_tpu.ops import msm_pallas as RMP
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import msm_pallas as MP
from hotproofs_tpu_torch.utils import bridge

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SPEC = C.PALLAS


def _gens(m, seed=0):
    rng = np.random.default_rng(seed)
    return [C.host_scalar_mul(SPEC, 1 + int.from_bytes(rng.bytes(31),
                                                       "little"), SPEC.gen)
            for _ in range(m)]


def _scalars(J, m, bits, seed):
    rng = np.random.default_rng(seed)
    ks = [[int.from_bytes(rng.bytes(32), "little") % (1 << bits)
           % SPEC.scalar.p for _ in range(m)] for _ in range(J)]
    ks[1] = [0] * m                       # an all-zero job: the identity
    ks[0][0] = 0                          # a zero digit run in a live job
    return ks


@pytest.mark.parametrize("bits", [40, 256])
@pytest.mark.parametrize("m", [1, 3, 20, 300])
def test_msm_many_vs_host_msm(m, bits):
    gens = _gens(m, seed=m)
    xa, ya = RMP.scaled_affine_host(RC.PALLAS, gens, RM.n_windows4(bits))
    bases = MP.bases_tm(*bridge.scaled_bases(xa, ya), m, bits)
    ks = _scalars(3, m, bits, seed=m + bits)
    sc = torch.stack([torch.from_numpy(SPEC.scalar.batch_to_limbs(k))
                      for k in ks])
    got = C.pt_to_affine_host(SPEC, MP.msm_many(SPEC, sc, bases, m, bits))
    assert got[1] is None
    assert got == [RC.host_msm(RC.PALLAS, k, gens) for k in ks]


def test_plan_and_layouts():
    for m, bits in [(1, 40), (300, 256), (15922, 40), (16162, 256)]:
        b, lpw, w4, n_lanes = MP.plan(m, bits)
        assert (b, lpw, w4, n_lanes) == (b, -(-m // b), RM.n_windows4(bits),
                                         w4 * lpw)
        assert b * lpw >= m and (m // b >= 16 or b == 8)
    # digit d of scalar j in window w sits at lane w * lpw + j // B, step
    # j % B.
    m, bits = 37, 16
    b, lpw, w4, _ = MP.plan(m, bits)
    rng = np.random.default_rng(1)
    sc = torch.from_numpy(rng.integers(0, 256, size=(2, m, 32),
                                       dtype=np.int32))
    d = MP.digits_tm(sc, m, b, lpw, w4)
    for j in (0, 5, 36):
        for w in range(w4):
            want = (int(sc[1, j, w // 2]) >> (4 * (w % 2))) & 0xF
            assert int(d[1, j % b, w * lpw + j // b]) == want


def test_to_affine_vs_scaled_affine_device_and_host():
    """Key preparation: scale_points16 + to_affine (plain) == the
    reference's device batch inversion (Pallas, interpret mode) == its
    host-exact path."""
    m, w4 = 20, 4
    gens = _gens(m, seed=9)
    xa_h, ya_h = RMP.scaled_affine_host(RC.PALLAS, gens, w4)
    pts = C.affine_to_mont(SPEC, gens)
    X, Y, Z = MP.scale_points16(SPEC, pts, w4)
    xa, ya = MP.to_affine(SPEC, X, Y, Z)
    assert np.array_equal(xa.numpy(), xa_h)
    assert np.array_equal(ya.numpy(), ya_h)
    ref_proj = tuple(jnp.asarray(c.numpy()) for c in (X, Y, Z))
    xa_d, ya_d = RMP.scaled_affine_device(RC.PALLAS, ref_proj, m, w4)
    assert np.array_equal(np.asarray(xa_d), xa.numpy())
    assert np.array_equal(np.asarray(ya_d), ya.numpy())


def test_scale_points16_vs_reference_host():
    gens = _gens(5, seed=4)
    X, Y, Z = MP.scale_points16(SPEC, C.affine_to_mont(SPEC, gens), 3)
    aff = C.pt_to_affine_host(SPEC, (X, Y, Z))
    want = []
    for w in range(3):
        for g in gens:
            want.append(RC.host_scalar_mul(RC.PALLAS, 16 ** w, g))
    assert aff == want


def test_commit_many_split_equals_full_width():
    """The small/large split commit == the plain full-width commit (the
    claim tests/test_pedersen_canon.py makes for the reference)."""
    m = 24
    ck = CommitmentKey.create(SPEC, b"test-torch-split", m)
    big = np.asarray([3, 17], np.int64)
    rng = np.random.default_rng(2)
    vals = [[int.from_bytes(rng.bytes(5), "little") for _ in range(m)]
            for _ in range(2)]
    for row in vals:
        for i in big:
            row[i] = int.from_bytes(rng.bytes(32), "little") % SPEC.scalar.p
    sc = torch.stack([torch.from_numpy(SPEC.scalar.batch_to_limbs(v))
                      for v in vals])
    split = ck.affine(ck.commit_many_split(sc, big))
    full = ck.affine(ck.commit_many(sc, 256))
    assert split == full
    rinv = pow(SPEC.base.r_mod_p, -1, SPEC.base.p)
    gens = [(RF.limbs_to_int(g[0]) * rinv % SPEC.base.p,
             RF.limbs_to_int(g[1]) * rinv % SPEC.base.p)
            for g in ck.gens_affine[:m]]
    assert split == [RC.host_msm(RC.PALLAS, v, gens) for v in vals]
    with pytest.raises(ValueError):
        bad = sc.clone()
        bad[0, 0, 6] = 1                  # 2^48 outside big_idx
        ck.commit_many_split(bad, big)


@pytest.mark.slow  # the reference's Pallas MSM in interpret mode (minutes)
def test_msm_many_vs_msm_pallas_many_interpret():
    m, bits = 24, 64
    gens = _gens(m, seed=11)
    w4 = RM.n_windows4(bits)
    xa, ya = RMP.scaled_affine_host(RC.PALLAS, gens, w4)
    b, lpw, _, n_lanes = RMP.plan(m, bits)
    px = jnp.asarray(RMP.to_tm(xa, m, b, lpw, w4, n_lanes))
    py = jnp.asarray(RMP.to_tm(ya, m, b, lpw, w4, n_lanes))
    ks = _scalars(3, m, bits, seed=12)
    sc_np = np.stack([RF.pallas_scalar.batch_to_limbs(k) for k in ks])
    ref = RMP.msm_pallas_many(RC.PALLAS, jnp.asarray(sc_np), px, py, m, bits)
    want = RC.pt_to_affine_host(RC.PALLAS, ref)
    bases = MP.bases_tm(torch.from_numpy(xa), torch.from_numpy(ya), m, bits)
    got = C.pt_to_affine_host(
        SPEC, MP.msm_many(SPEC, torch.from_numpy(sc_np), bases, m, bits))
    assert got == want
