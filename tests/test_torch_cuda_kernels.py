"""The CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: without a CUDA device each test skips (the decision is made
inside the fixture, never at import). On a machine with the card (which
has no jax, so the JAX package's tests/conftest.py is not loaded):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import msm_pallas as MP
from hotproofs_tpu_torch.ops import pallas_field as PF
from hotproofs_tpu_torch.ops import poseidon as P
from hotproofs_tpu_torch.tools import field_mul as FM
from hotproofs_tpu_torch.tools import wsum_affine as WA
from torch_table_edges import edge_tables

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


def test_to_affine_kernel_vs_plain_across_blocks(dev):
    """The batch inversion over 3 1/4 blocks == the Fermat plain version:
    Z = 0 at one point, at every point of a thread of block 0, at every
    point of block 1, and at every point of a thread of the last block,
    which ends mid-thread."""
    T, c, blk = MP.AFFINE_THREADS, MP.AFFINE_PER_THREAD, MP.AFFINE_BLOCK
    n = 3 * blk + 3 * T + 9
    X, Y, Z = WA.random_projective(np.random.default_rng(5), n, dev)
    zero = [5] + [k * T + 7 for k in range(c)] + list(range(blk, 2 * blk)) \
        + [3 * blk + k * T + 3 for k in range(4)]
    Z[zero] = 0
    before = MP.launches["to_affine"]
    got = MP.to_affine_words(SPEC, X, Y, Z)
    assert MP.launches["to_affine"] == before + 1
    want = MP.to_affine_words_plain(SPEC, X, Y, Z)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert not g[zero].any()


@pytest.mark.parametrize("S", [15, 8])
@pytest.mark.parametrize("J", [0, 1, 2, 256])
def test_wsum_kernel_vs_plain(dev, J, S):
    """The warp-parallel weighted sum == its plain version: a tenth of the
    slots the identity, and job 0 all identity."""
    red = WA.random_reduced(np.random.default_rng(J + S), J, S, dev)
    if J:
        red[0] = 0
        red[0, :, 1] = F.digits_to_words(torch.from_numpy(
            SPEC.base.one_mont_limbs).to(dev))
    before = MP.launches["msm_wsum"]
    got = MP.msm_wsum(SPEC, red)
    assert MP.launches["msm_wsum"] == before + (1 if J else 0)
    assert got.shape == (J, 3, 8)
    assert torch.equal(got, MP.msm_wsum_plain(SPEC, red))
    if J:
        assert not got[0, 2].any()


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


@pytest.mark.parametrize("bits", [40, 256])
def test_design_kernels_vs_plain_and_host(dev, key, bits):
    """msm_chain, msm_bucket_tsplit (H = 2, 4), msm_bucket_signed and the
    S = 8 merge and wsum: kernel == plain; each MSM == host_msm."""
    ck, gens = key
    m = len(gens)
    rng = np.random.default_rng(bits + 1)
    raw = rng.integers(0, 256, size=(3, m, 32), dtype=np.int64)
    raw[..., (bits + 7) // 8:] = 0
    raw[:, :, 31] &= 0x3F
    raw[0, 1, (bits - 1) // 8] |= 0xF0 if bits == 40 else 0
    raw[1] = 0
    sc = torch.from_numpy(raw.astype(np.int32)).to(dev)
    want = [C.host_msm(SPEC, [F.limbs_to_int(r) for r in raw[j]], gens)
            for j in range(3)]
    sums = lambda bk: ck.affine(tuple(
        F.words_to_digits(MP.msm_wsum(SPEC, MP.msm_merge(SPEC, bk)))
        .unbind(1)))
    b, lpw, w4, _ = MP.plan(m, bits)
    d = MP.digits_tm(sc, m, b, lpw, w4)
    bases = ck.bases(m, bits)
    ch = MP.msm_chain(SPEC, bases, 3)
    assert torch.equal(ch, MP.msm_chain_plain(SPEC, bases, 3))
    for H in (2, 4):
        bk = MP.msm_bucket_tsplit(SPEC, d, bases, H)
        assert torch.equal(bk, MP.msm_bucket_tsplit_plain(SPEC, d, bases, H))
        assert sums(bk) == want
    sbits = MP.signed_bits(bits)
    b, lpw, w4, _ = MP.plan(m, sbits)
    sd = MP.signed_digits_tm(sc, m, b, lpw, w4)
    sbases = ck.bases(m, sbits)
    bk = MP.msm_bucket_signed(SPEC, sd, sbases)
    assert torch.equal(bk, MP.msm_bucket_signed_plain(SPEC, sd, sbases))
    red = MP.msm_merge(SPEC, bk)
    assert torch.equal(red, MP.msm_merge_plain(SPEC, bk))
    assert torch.equal(MP.msm_wsum(SPEC, red), MP.msm_wsum_plain(SPEC, red))
    assert sums(bk) == want


@pytest.mark.parametrize("design,H", [("tsplit", 4), ("tsplit", 2),
                                      ("signed", 1)])
def test_walk_design_kernels_on_sparse_digits(dev, design, H):
    """The t-split and signed kernels (msm_bucket's sorted walk over a step
    range, over signed digits) at B = 64 on digits as sparse as the W
    commits' (a tenth of the lanes half nonzero, as window 0, the rest
    0.3 %), an all-zero job: kernel == plain bit for bit, with the
    lane-major bases given and made by the wrapper, one launch each."""
    rng = np.random.default_rng(H)
    J, B, L = 3, MP.BUCKET_MAX_STEPS, 1000
    top = MP.NSIGNED if design == "signed" else MP.NBUCKET
    d = rng.integers(1, top + 1, size=(J, B, L))
    if design == "signed":
        d |= rng.integers(0, 2, size=(J, B, L)) << 4
    dense = np.arange(L) < L // 10
    d *= rng.random((J, B, L)) < np.where(dense, 0.5, 0.003)
    d[1] = 0
    d = torch.from_numpy(d.astype(np.int32)).to(dev)
    w = rng.integers(0, 1 << 32, size=(B, 2, 8, L), dtype=np.uint32)
    w[:, :, 7] &= 0x3FFFFFFF                # canonical: below 2^254 < p
    tm = torch.from_numpy(w.view(np.int32)).to(dev)
    lm = MP.lane_major(tm)
    if design == "signed":
        kern = lambda x: MP.msm_bucket_signed(SPEC, d, tm, x)
        want = MP.msm_bucket_signed_plain(SPEC, d, tm)
    else:
        kern = lambda x: MP.msm_bucket_tsplit(SPEC, d, tm, H, x)
        want = MP.msm_bucket_tsplit_plain(SPEC, d, tm, H)
    name = f"msm_bucket_{design}"
    before = MP.launches[name]
    for x in (lm, None):
        assert torch.equal(kern(x), want)
    assert MP.launches[name] == before + 2
    assert not bool(want[1, :, 2].any())


@pytest.mark.parametrize("n,windows", [(1, 64), (37, 10), (300, 64),
                                       (45, 1), (33, 2)])
def test_scale16_kernel_vs_plain(dev, n, windows):
    """scale16 == its plain version bit for bit (the same Jacobian
    doublings), the identity kept as (0 : 1 : 0)."""
    pts = [C.host_scalar_mul(SPEC, 3 + 7 * i, SPEC.gen) for i in range(n)]
    pts[n // 2] = None
    P = MP.point_words(C.affine_to_mont(SPEC, pts, dev))
    before = MP.launches["scale16"]
    got = MP.scale16(SPEC, P, windows)
    assert MP.launches["scale16"] == before + 1
    assert torch.equal(got, MP.scale16_plain(SPEC, P, windows))
    assert not bool(got[:, n // 2, 2].any())
    assert bool(got[:, n // 2, 1].any())


@pytest.mark.parametrize("m", [1, 2, 3, 8, 16, 1000])
def test_msm_var_on_the_card_vs_host(dev, m):
    """msm_var (scale16, to_affine, the MSM chain) over points with an
    identity among them == the host MSM, at small sizes and at one
    large."""
    rng = np.random.default_rng(m)
    pts = [C.host_scalar_mul(SPEC, 1 + int(rng.integers(1 << 40)),
                             SPEC.gen) for _ in range(m)]
    pts[m // 2] = None
    ks = [[int.from_bytes(rng.bytes(32), "little") % SPEC.scalar.p
           for _ in range(m)] for _ in range(2)]
    sc = torch.from_numpy(np.stack([SPEC.scalar.batch_to_limbs(k)
                                    for k in ks])).to(dev)
    kept = MP.var_bases(SPEC, MP.point_words(C.affine_to_mont(SPEC, pts,
                                                               dev)), 256)
    got = C.pt_to_affine_host(SPEC, MP.msm_var(SPEC, sc, kept, 256))
    assert got == [C.host_msm(SPEC, k, pts) for k in ks]


def test_wrappers_reject_bad_inputs(dev):
    d = torch.zeros((1, 8, 4), dtype=torch.int64, device=dev)
    bases = torch.zeros((8, 2, 8, 4), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        MP.msm_bucket(SPEC, d, bases)
    with pytest.raises(ValueError):
        MP.msm_bucket(SPEC, d.to(torch.int32), bases.cpu())


@pytest.mark.parametrize("name", ["pallas_base", "vesta_base", "bn254_base"])
def test_field_multiply_kernels_vs_plain(dev, name):
    """mont_mul in its three formats and with broadcast operands, the five
    stages, the three parts and conv_mma == their plain versions, at a
    size that is no multiple of 512, 128 or 8."""
    spec = F.FIELDS[name]
    n = 1037
    rng = np.random.default_rng(len(name))
    a, b = (FM.random_elements(rng, spec, n, dev) for _ in range(2))
    edge = torch.from_numpy(spec.batch_to_limbs(
        [0, spec.p - 1, 1, 0, spec.p - 1, spec.p - 1])).to(dev)
    a[:3], b[:3] = edge[:3], edge[3:]
    at, bt = a.T.contiguous(), b.T.contiguous()
    before = dict(PF.launches)
    want = PF.mont_mul_em_plain(spec, a, b)
    assert torch.equal(PF.mont_mul_em(spec, a, b), want)
    assert torch.equal(F.mont_mul(spec, a, b), want)
    assert torch.equal(PF.mont_mul_lm(spec, at, bt), want.T)
    aw, bw = F.digits_to_words(a), F.digits_to_words(b)
    assert torch.equal(PF.mont_mul_words(spec, aw, bw),
                       PF.mont_mul_words_plain(spec, aw, bw))
    assert PF.launches["mont_mul"] == before["mont_mul"] + 4
    # broadcasts: a constant, a repeated block, a written-out one, strides
    a3 = a[:1020].reshape(4, 255, 32)
    for x, y in ((a3, b[7]), (a3, b[:255]), (b[None, :255], a3),
                 (a3, b[:4].reshape(4, 1, 32)), (a3[:, ::2], b[:128])):
        assert torch.equal(PF.mont_mul_em(spec, x, y),
                           PF.mont_mul_em_plain(spec, x, y))
    assert torch.equal(F.to_mont(spec, a), PF.mont_mul_em_plain(
        spec, a, PF.const_digits(spec, "r2", dev)))
    assert torch.equal(F.from_mont(spec, F.to_mont(spec, a)), a)
    for stage in PF.STAGES:
        assert torch.equal(PF.mont_mul_stage(spec, at, bt, stage),
                           PF.mont_mul_stage_plain(spec, at, bt, stage))
    assert torch.equal(PF.mont_mul_stage(spec, at, bt, 5), want.T)
    for part in PF.PARTS:
        assert torch.equal(PF.mont_mul_part(spec, at, bt, part),
                           PF.mont_mul_part_plain(spec, at, bt, part))
    got = PF.conv_mma(at, bt)
    assert torch.equal(got, PF.conv_mma_plain(at, bt))
    assert torch.equal(got & 0xFF, PF.mont_mul_part(spec, at, bt, "conv"))
    assert PF.launches["mont_mul_stage"] == before["mont_mul_stage"] + 6
    assert PF.launches["mont_mul_part"] == before["mont_mul_part"] + 4
    assert PF.launches["conv_mma"] == before["conv_mma"] + 1


def test_field_multiply_wrappers_reject_bad_inputs(dev):
    spec = F.pallas_base
    em = FM.random_elements(np.random.default_rng(0), spec, 16, dev)
    lm = em.T.contiguous()
    with pytest.raises(TypeError):
        F.mont_mul(spec, em.to(torch.int64), em)
    with pytest.raises(ValueError):
        PF.mont_mul_em(spec, em, em.cpu())
    with pytest.raises(ValueError):
        PF.mont_mul_em(spec, em[:, :8], em[:, :8])
    for fn in (lambda x, y: PF.mont_mul_lm(spec, x, y),
               lambda x, y: PF.mont_mul_stage(spec, x, y, 1),
               lambda x, y: PF.mont_mul_part(spec, x, y, "norm"),
               PF.conv_mma):
        with pytest.raises(ValueError):
            fn(em, em)                    # element-major where (32, N) is due
        with pytest.raises(ValueError):
            fn(em.T, em.T)                # limb-major view, not contiguous
        with pytest.raises(ValueError):
            fn(lm, lm.cpu())
        with pytest.raises(TypeError):
            fn(lm.to(torch.int64), lm)
    with pytest.raises(ValueError):
        PF.mont_mul_words(spec, em, em)


@pytest.mark.parametrize("H", [1, 2, 4, 32])
def test_msm_chain_kernel_at_every_split(dev, H):
    """msm_chain with H sub-chains a lane (the lean add and the shuffle
    tree) == its plain version bit for bit at B = 64, over lanes that
    leave a warp part-filled; chain_split's own H too; a B that H does
    not divide is refused."""
    rng = np.random.default_rng(H)
    L, B = 45, 64
    w = rng.integers(0, 1 << 32, size=(B, 2, 8, L), dtype=np.uint64)
    w[:, :, 7] &= 0x3FFFFFFF
    bases = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)
    for h in (H, None):
        got = MP.msm_chain(SPEC, bases, 2, h)
        assert torch.equal(got, MP.msm_chain_plain(SPEC, bases, 2, h))
    with pytest.raises(ValueError):
        MP.msm_chain(SPEC, bases[:48], 1, 32)


@pytest.mark.parametrize("name", ["pallas", "bn254", "grumpkin"])
def test_h_tables_kernel_on_edge_rows(dev, name):
    """h_tables on the card == its plain version bit for bit on the edge
    rows of tests/torch_table_edges.py (empty rows, one digit, 259
    full-width negated values, every lane on one digit value), on Pasta,
    BN254 and Grumpkin (3b = 15, 9, -51 through the lean backend)."""
    from hotproofs_tpu_torch.ops import tables as TB
    spec = C.CURVES[name]
    rng = np.random.default_rng(5)
    n = 16
    b, lpw, _, n_lanes = MP.plan(n, 256)
    w = rng.integers(0, 1 << 32, size=(n_lanes, b, 2, 8), dtype=np.uint64)
    w[..., 7] &= 0x0FFFFFFF                 # canonical in all four fields
    bl = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)
    csr, _, _, _ = edge_tables(spec, n, rng)
    csr = TB.TableCSR(**{k: getattr(csr, k).to(dev) for k in (
        "row_ptr", "order", "alloc", "cols", "mag", "neg")})
    before = MP.launches["h_tables"]
    got = TB.h_tables(spec, csr, bl, lpw)
    assert MP.launches["h_tables"] == before + 1
    assert torch.equal(got, TB.h_tables_plain(spec, csr, bl, lpw))


@pytest.mark.parametrize("spec", [
    P.make_spec("pallas_scalar"), P.make_spec_neptune("vesta_scalar", 2),
    P.make_spec("bn254_scalar"), P.make_spec("grumpkin_scalar"),
    P.make_spec("pallas_scalar", t=5), P.make_spec("pallas_scalar", t=9)],
    ids=lambda s: f"{s.field.name}-t{s.t}-{s.r_partial}")
def test_poseidon_kernel_vs_plain_and_host(dev, spec):
    """poseidon_permute == permute_plain on the card, one launch a call,
    over 133 states (a part-filled block) with the edge states 0 and
    p - 1 and a batch of two leading axes; 4 states == host_permute."""
    fld = spec.field
    rng = np.random.default_rng(spec.t)
    x = FM.random_elements(rng, fld, 133 * spec.t, dev).reshape(
        133, spec.t, 32)
    x[0] = 0
    x[1] = torch.from_numpy(fld.batch_to_limbs([fld.p - 1] * spec.t)).to(
        dev)
    before = P.launches["poseidon_permute"]
    got = P.permute(spec, x)
    assert P.launches["poseidon_permute"] == before + 1
    assert torch.equal(got, P.permute_plain(spec, x))
    y = x[:12].reshape(3, 4, spec.t, 32)
    assert torch.equal(P.permute(spec, y), got[:12].reshape(y.shape))
    ints = F.to_ints(fld, x[:4], mont=True)
    want = [v for k in range(4)
            for v in P.host_permute(spec, ints[k * spec.t:(k + 1) * spec.t])]
    assert F.to_ints(fld, got[:4], mont=True) == want


def test_poseidon_wrapper_rejects_bad_inputs(dev):
    spec = P.make_spec("pallas_scalar")
    x = torch.zeros((4, 3, 32), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        P.permute(spec, x.to(torch.int64))
    with pytest.raises(ValueError):
        P.permute(spec, x[:, :2])
    t2 = P.make_spec("pallas_scalar", t=2)
    with pytest.raises(ValueError, match="t in"):
        P.permute(t2, x[:, :2].contiguous())
    assert P.permute(spec, x[:0]).shape == (0, 3, 32)
