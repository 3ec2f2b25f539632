"""The four CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: without a CUDA device each test skips (the decision is made
inside the fixture, never at import). On a machine with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import msm_pallas as MP

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
SPEC = C.PALLAS


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def key(dev):
    gens = C.derive_generators(SPEC, b"test-cuda-kernels", 40)
    g = np.zeros((len(gens), 2, 32), np.int32)
    for i, (x, y) in enumerate(gens):
        g[i, 0] = F.int_to_limbs(SPEC.base.to_mont_int(x))
        g[i, 1] = F.int_to_limbs(SPEC.base.to_mont_int(y))
    return CommitmentKey(SPEC, len(gens), g, b"", dev), gens


def test_to_affine_kernel_vs_plain(dev, key):
    ck, _ = key
    X, Y, Z = (F.digits_to_words(c.reshape(-1, 32))
               for c in MP.scale_points16(SPEC, ck.points, 8))
    Z[3] = 0
    before = MP.launches["to_affine"]
    got = MP.to_affine_words(SPEC, X, Y, Z)
    assert MP.launches["to_affine"] == before + 1
    want = MP.to_affine_words_plain(SPEC, X, Y, Z)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bits", [40, 256])
def test_msm_chain_kernels_vs_plain_and_host(dev, key, bits):
    ck, gens = key
    m = len(gens)
    rng = np.random.default_rng(bits)
    raw = rng.integers(0, 256, size=(3, m, 32), dtype=np.int64)
    raw[..., (bits + 7) // 8:] = 0
    raw[:, :, 31] &= 0x3F
    raw[1] = 0
    sc = torch.from_numpy(raw.astype(np.int32)).to(dev)
    b, lpw, w4, _ = MP.plan(m, bits)
    d = MP.digits_tm(sc, m, b, lpw, w4)
    bases = ck.bases(m, bits)
    bk = MP.msm_bucket(SPEC, d, bases)
    assert torch.equal(bk, MP.msm_bucket_plain(SPEC, d, bases))
    red = MP.msm_merge(SPEC, bk)
    assert torch.equal(red, MP.msm_merge_plain(SPEC, bk))
    s = MP.msm_wsum(SPEC, red)
    assert torch.equal(s, MP.msm_wsum_plain(SPEC, red))
    got = ck.affine(MP.msm_many(SPEC, sc, bases, m, bits))
    want = [C.host_msm(SPEC, [F.limbs_to_int(r) for r in raw[j]], gens)
            for j in range(3)]
    assert got == want and got[1] is None


def test_wrappers_reject_bad_inputs(dev):
    d = torch.zeros((1, 8, 4), dtype=torch.int64, device=dev)
    bases = torch.zeros((8, 2, 8, 4), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        MP.msm_bucket(SPEC, d, bases)
    with pytest.raises(ValueError):
        MP.msm_bucket(SPEC, d.to(torch.int32), bases.cpu())
