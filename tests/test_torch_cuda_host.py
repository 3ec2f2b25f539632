"""The CUDA kernels' arithmetic and per-thread bodies, built for the host.

csrc/field.cuh, curve.cuh, msm.cuh, msm_designs.cuh and mont.cuh compile with g++ when
__CUDACC__ is undefined; csrc/host_check.cc wraps them in a ctypes library
(built here into a temporary directory, as core/native_ff.py builds
ffec.so). This checks the CIOS multiply and the RCB15 point formulas
against the Python oracles, and runs each kernel's exact per-thread code
over every index of a launch (the merge kernel's shared-memory tree
replayed in order) against the plain torch versions: the only way the
CPU tier sees the arithmetic the card runs."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import msm_pallas as MP
from hotproofs_tpu_torch.ops import pallas_field as PF

CSRC = pathlib.Path(__file__).resolve().parents[1] / "hotproofs_tpu_torch" \
    / "csrc"

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hc(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host library")
    so = tmp_path_factory.mktemp("hc") / "libhost_check.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-Wno-unknown-pragmas", "-fPIC", "-shared", "-o",
                    str(so), str(CSRC / "host_check.cc")], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(str(so))


def _p(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _words(t: torch.Tensor) -> np.ndarray:
    """(..., 32) digits -> contiguous uint32 words."""
    return np.ascontiguousarray(F.digits_to_words(t).numpy().view(np.uint32))


def _digits(w: np.ndarray) -> torch.Tensor:
    return F.words_to_digits(torch.from_numpy(w.view(np.int32)))


@pytest.mark.parametrize("name", ["pallas", "vesta", "bn254", "grumpkin"])
def test_field_ops_vs_ints(hc, name):
    spec = C.CURVES[name]
    f = spec.base
    rng = np.random.default_rng(len(name))
    xs = [int.from_bytes(rng.bytes(32), "little") % f.p for _ in range(64)]
    ys = [int.from_bytes(rng.bytes(32), "little") % f.p for _ in range(64)]
    xs[:3], ys[:3] = [0, f.p - 1, f.p - 1], [f.p - 1, f.p - 1, 0]
    a = _words(torch.from_numpy(f.batch_to_limbs(xs)))
    b = _words(torch.from_numpy(f.batch_to_limbs(ys)))
    cw = MP.consts_words(spec)
    rinv = pow(1 << 256, -1, f.p)
    for fn, want in ((hc.hc_mont_mul, [x * y * rinv for x, y in zip(xs, ys)]),
                     (hc.hc_add, [x + y for x, y in zip(xs, ys)]),
                     (hc.hc_sub, [x - y for x, y in zip(xs, ys)])):
        out = np.zeros_like(a)
        fn(_p(cw), _p(a), _p(b), _p(out), len(xs))
        assert F.to_ints(f, _digits(out)) == [w % f.p for w in want]


def _proj_words(pt):
    return np.ascontiguousarray(np.stack([_words(c) for c in pt], axis=1))


@pytest.mark.parametrize("name", ["pallas", "bn254"])
def test_point_ops_vs_plain_and_oracle(hc, name):
    spec = C.CURVES[name]
    rng = np.random.default_rng(3)
    pts = [C.host_scalar_mul(spec, 1 + int(rng.integers(1 << 62)), spec.gen)
           for _ in range(16)]
    qts = [C.host_scalar_mul(spec, 1 + int(rng.integers(1 << 62)), spec.gen)
           for _ in range(16)]
    pts[0] = None
    pts[1] = qts[1]
    pts[2] = (qts[2][0], (-qts[2][1]) % spec.base.p)
    P, Q = C.affine_to_mont(spec, pts), C.affine_to_mont(spec, qts)
    cw = MP.consts_words(spec)
    plain = {0: C.pt_add(spec, P, Q),
             1: C.pt_add_mixed(spec, P, (Q[0], Q[1])),
             2: C.pt_double(spec, P),
             3: C.pt_neg(spec, P)}
    pw, qw = _proj_words(P), _proj_words(Q)
    for op, want in plain.items():
        out = np.zeros_like(pw)
        hc.hc_point_op(_p(cw), _p(pw), _p(qw), _p(out), len(pts), op)
        got = tuple(_digits(out[:, c]) for c in range(3))
        for g, w in zip(got, want):
            assert torch.equal(g, w), op
    got = C.pt_to_affine_host(spec, plain[1])
    assert got == [C.host_add(spec, p, q) for p, q in zip(pts, qts)]


@pytest.mark.parametrize("m,bits", [(3, 256), (600, 64)])
def test_msm_kernel_bodies_vs_plain(hc, m, bits):
    """bucket -> merge -> wsum per-thread code == the plain versions,
    stage by stage, bit for bit (600 points at 64 bits give 304 lanes:
    some merge threads sum two lanes before the tree)."""
    spec = C.PALLAS
    rng = np.random.default_rng(m)
    w4 = MP.n_windows4(bits)
    # random field elements as bases: the formulas are total, and every
    # stage must agree on any input
    f = spec.base
    xa, ya = (torch.from_numpy(f.batch_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % f.p
         for _ in range(w4 * m)]).reshape(w4, m, 32)) for _ in range(2))
    bases = MP.bases_tm(xa, ya, m, bits)
    raw = rng.integers(0, 256, size=(2, m, 32), dtype=np.int64)
    raw[..., (bits + 7) // 8:] = 0
    raw[1] = 0
    b, lpw, w4, n_lanes = MP.plan(m, bits)
    d = MP.digits_tm(torch.from_numpy(raw.astype(np.int32)), m, b, lpw, w4)
    cw = MP.consts_words(spec)

    bk = MP.msm_bucket_plain(spec, d, bases)
    dn = np.ascontiguousarray(d.numpy())
    bn = np.ascontiguousarray(MP.lane_major(bases).numpy().view(np.uint32))
    bk_h = np.zeros(tuple(bk.shape), np.uint32)
    hc.hc_msm_bucket(_p(cw), _p(dn), _p(bn), _p(bk_h), 2, b, n_lanes)
    assert np.array_equal(bk_h.view(np.int32), bk.numpy())

    red = MP.msm_merge_plain(spec, bk)
    red_h = np.zeros(tuple(red.shape), np.uint32)
    hc.hc_msm_merge(_p(cw), _p(bk_h), _p(red_h), 2, MP.NBUCKET, n_lanes)
    assert np.array_equal(red_h.view(np.int32), red.numpy())

    s = MP.msm_wsum_plain(spec, red)
    s_h = np.zeros(tuple(s.shape), np.uint32)
    hc.hc_msm_wsum(_p(cw), _p(red_h), _p(s_h), 2, MP.NBUCKET)
    assert np.array_equal(s_h.view(np.int32), s.numpy())


def test_msm_constants_match_the_python_twins(hc):
    """csrc/msm.cuh's launch constants, merge_group and wsum_group ==
    msm_pallas's."""
    got = np.zeros(9, np.int32)
    hc.hc_msm_constants(_p(got))
    assert got.tolist() == [MP.NBUCKET, MP.BUCKET_LANES, MP.BUCKET_MAX_STEPS,
                            MP.MERGE_THREADS, MP.MERGE_TARGET_THREADS,
                            MP.WSUM_THREADS, MP.WSUM_MAX_SLOTS,
                            MP.AFFINE_THREADS, MP.AFFINE_PER_THREAD]
    for S in range(1, MP.WSUM_MAX_SLOTS + 1):
        G = hc.hc_wsum_group(S)
        assert G == MP.wsum_group(S) and G >= S and 32 % G == 0
        assert G == 1 or G < 2 * S
    assert (MP.wsum_depth(15), MP.wsum_depth(8), MP.wsum_depth(1)) == (8, 6, 0)
    for J in (1, 2, 16, 35, 36, 256, 4096):
        for S in (1, 8, 15):
            for L in (0, 1, 31, 33, 255, 256, 257, 2490, 16192, 64704,
                      1 << 20):
                G = hc.hc_merge_group(J, S, L)
                assert G == MP.merge_group(J, S, L)
                assert G >= 32 and G & (G - 1) == 0
    assert MP.merge_group(1, 15, 16192) == 4096    # comm_T: 32 blocks a slot
    assert MP.merge_group(16, 15, 2490) == 256     # W J=16: 2 blocks a slot
    assert MP.merge_group(256, 15, 2490) == 32     # W J=256: a warp a slot


def _random_points(rng, f, shape):
    """Random canonical field elements, below 2^254 < p, as (..., 3, 8)
    uint32 words: the formulas are total, so every stage must agree on any
    input."""
    assert f.p > 1 << 254
    w = rng.integers(0, 1 << 32, size=(*shape, 3, 8), dtype=np.uint32)
    w[..., 7] &= 0x3FFFFFFF
    return w


@pytest.mark.parametrize("J,S,L", [(71, 15, 40), (50, 15, 100),
                                   (40, 8, 100), (2, 15, 200), (1, 8, 700)])
def test_merge_body_vs_plain_with_empty_buckets(hc, J, S, L):
    """K2's groups, warp trees and last-block finish under g++ == the
    plain version, bit for bit, at S = 15 and 8: G = 32, 64 and 128
    threads a slot (4, 2 and 1 slots a block) and G = 256 and 1,024 (2
    and 8 blocks a slot); lanes no multiple of G; about half the buckets
    empty (Z = 0) and one job all empty."""
    spec = C.PALLAS
    rng = np.random.default_rng(J * S + L)
    pts = _random_points(rng, spec.base, (J, S, L))         # (J, S, L, 3, 8)
    empty = rng.random((J, S, L)) < 0.5
    empty[-1] = True
    one = _words(torch.from_numpy(spec.base.one_mont_limbs))
    pts[empty] = 0
    pts[empty, 1] = one
    bk = np.ascontiguousarray(pts.transpose(0, 1, 3, 4, 2))  # (J, S, 3, 8, L)
    G = MP.merge_group(J, S, L)
    assert L % G and G & (G - 1) == 0
    want = MP.msm_merge_plain(spec, torch.from_numpy(bk.view(np.int32)))
    got = _host(hc, "hc_msm_merge", want.shape, _p(MP.consts_words(spec)),
                _p(bk), (J, S, L))
    assert np.array_equal(got, want.numpy())
    assert not got[-1, :, 2].any()                  # the empty job: identity


def test_bucket_walk_vs_plain_on_sparse_digits(hc):
    """K1's sorted walk over lane-major bases under g++ == msm_bucket_plain
    over the time-major ones, bit for bit, at the kernel's largest B: 95 %
    zero digits, a lane with every step nonzero, a lane of one repeated
    digit and a job with no nonzero digit."""
    spec = C.PALLAS
    rng = np.random.default_rng(41)
    J, B, L = 3, MP.BUCKET_MAX_STEPS, 37
    d = rng.integers(1, 16, size=(J, B, L)) * (rng.random((J, B, L)) < 0.05)
    d[0, :, 0] = rng.integers(1, 16, size=B)
    d[0, :, 1] = 7
    d[2] = 0
    d = np.ascontiguousarray(d.astype(np.int32))
    bases = _random_points(rng, spec.base, (B, L))[:, :, :2]  # (B, L, 2, 8)
    tm = torch.from_numpy(np.ascontiguousarray(
        bases.transpose(0, 2, 3, 1)).view(np.int32))          # (B, 2, 8, L)
    lm = MP.lane_major(tm)
    assert lm.shape == (L, B, 2, 8) and torch.equal(lm[5, 9], tm[9, :, :, 5])
    want = MP.msm_bucket_plain(spec, torch.from_numpy(d), tm)
    got = _host(hc, "hc_msm_bucket", want.shape, _p(MP.consts_words(spec)),
                _p(d), _p(lm.numpy()), (J, B, L))
    assert np.array_equal(got, want.numpy())
    assert not got[2, :, 2].any()


def _host(hc, name, shape, *args):
    """Run host_check's `name` into a fresh uint32 output of `shape`;
    return it as int32 (the wrappers' dtype)."""
    out = np.zeros(tuple(shape), np.uint32)
    getattr(hc, name)(*args[:-1], _p(out), *args[-1])
    return out.view(np.int32)


@pytest.mark.parametrize("m,bits", [(20, 256), (300, 40)])
def test_design_kernel_bodies_vs_plain(hc, m, bits):
    """msm_chain, msm_bucket_tsplit (H = 2, 4), msm_bucket_signed and the
    S = 8 merge and wsum: per-thread code == plain versions, bit for bit."""
    spec = C.PALLAS
    f = spec.base
    rng = np.random.default_rng(m + bits)
    sbits = MP.signed_bits(bits)
    b, lpw, w4, n_lanes = MP.plan(m, sbits)
    xa, ya = (torch.from_numpy(f.batch_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % f.p
         for _ in range(w4 * m)]).reshape(w4, m, 32)) for _ in range(2))
    bases = MP.bases_tm(xa, ya, m, sbits)
    bn = np.ascontiguousarray(bases.numpy().view(np.uint32))
    raw = rng.integers(0, 256, size=(2, m, 32), dtype=np.int64)
    raw[..., (bits + 7) // 8:] = 0
    raw[:, :, 31] &= 0x3F
    if bits % 8 == 0 and bits < 256:
        raw[0, 1, bits // 8 - 1] |= 0xF0          # top nibble 15
    raw[1] = 0
    sc = torch.from_numpy(raw.astype(np.int32))
    cw = MP.consts_words(spec)

    ch = MP.msm_chain_plain(spec, bases, 2)
    assert np.array_equal(_host(hc, "hc_msm_chain", ch.shape, _p(cw),
                                _p(bn), (2, b, n_lanes)), ch.numpy())

    d = MP.digits_tm(sc, m, b, lpw, w4)
    dn = np.ascontiguousarray(d.numpy())
    for H in (2, 4):
        ts = MP.msm_bucket_tsplit_plain(spec, d, bases, H)
        assert ts.shape == (2, MP.NBUCKET, 3, 8, H * n_lanes)
        assert np.array_equal(_host(
            hc, "hc_msm_bucket_tsplit", ts.shape, _p(cw), _p(dn), _p(bn),
            (2, b, n_lanes, H)), ts.numpy()), H

    sd = MP.signed_digits_tm(sc, m, b, lpw, w4)
    sn = np.ascontiguousarray(sd.numpy())
    sg = MP.msm_bucket_signed_plain(spec, sd, bases)
    sg_h = _host(hc, "hc_msm_bucket_signed", sg.shape, _p(cw), _p(sn),
                 _p(bn), (2, b, n_lanes))
    assert np.array_equal(sg_h, sg.numpy())

    red = MP.msm_merge_plain(spec, sg)
    assert red.shape == (2, MP.NSIGNED, 3, 8)
    red_h = _host(hc, "hc_msm_merge", red.shape, _p(cw),
                  _p(np.ascontiguousarray(sg_h)), (2, MP.NSIGNED, n_lanes))
    assert np.array_equal(red_h, red.numpy())
    s = MP.msm_wsum_plain(spec, red)
    s_h = _host(hc, "hc_msm_wsum", s.shape, _p(cw),
                _p(np.ascontiguousarray(red_h)), (2, MP.NSIGNED))
    assert np.array_equal(s_h, s.numpy())


def test_to_affine_body_vs_plain_and_host(hc):
    spec = C.PALLAS
    rng = np.random.default_rng(8)
    gens = [C.host_scalar_mul(spec, 1 + int(rng.integers(1 << 62)),
                              spec.gen) for _ in range(6)]
    X, Y, Z = (c.reshape(-1, 32) for c in MP.scale_points16(
        spec, C.affine_to_mont(spec, gens), 3))
    Z = Z.clone()
    Z[4] = 0                                   # z = 0 -> (0, 0)
    Xw, Yw, Zw = (_words(c) for c in (X, Y, Z))
    x_h, y_h = np.zeros_like(Xw), np.zeros_like(Yw)
    hc.hc_to_affine(_p(MP.consts_words(spec)), _p(Xw), _p(Yw), _p(Zw),
                    _p(x_h), _p(y_h), ctypes.c_longlong(len(Xw)))
    xp, yp = MP.to_affine_words_plain(spec, *(F.digits_to_words(c)
                                              for c in (X, Y, Z)))
    assert np.array_equal(x_h.view(np.int32), xp.numpy())
    assert np.array_equal(y_h.view(np.int32), yp.numpy())
    assert not x_h[4].any() and not y_h[4].any()
    xa, ya = MP.scaled_affine_host(spec, gens, 3)
    keep = [i for i in range(len(Xw)) if i != 4]
    assert np.array_equal(_digits(x_h).numpy()[keep],
                          xa.reshape(-1, 32)[keep])


def _identity_words(spec):
    """(3, 8) uint32 words of the projective identity (0 : 1 : 0)."""
    w = np.zeros((3, 8), np.uint32)
    w[1] = _words(torch.from_numpy(spec.base.one_mont_limbs))
    return w


@pytest.mark.parametrize("S,J", [(15, 1), (15, 3), (15, 5), (8, 1), (8, 3),
                                 (8, 5), (1, 3), (3, 5), (17, 3), (32, 2)])
def test_wsum_warp_replay_vs_plain(hc, S, J):
    """K3's warp schedule under g++ (lanes, suffix-scan and tree shuffles,
    identity skips) == the plain version, bit for bit: G = 16 lanes and 2
    jobs a warp at S = 15, 8 and 4 at S = 8, up to a whole warp at S = 32;
    jobs that end mid-warp; about a third of the slots the identity, one
    job all identity, and at S = 15 the last slot (the one every T_v
    holds) empty in one job."""
    spec = C.PALLAS
    rng = np.random.default_rng(100 * S + J)
    red = _random_points(rng, spec.base, (J, S))              # (J, S, 3, 8)
    empty = rng.random((J, S)) < 1 / 3
    empty[J // 2] = True
    if S == 15:
        empty[0, S - 1] = True
    red[empty] = _identity_words(spec)
    want = MP.msm_wsum_plain(spec, torch.from_numpy(red.view(np.int32)))
    got = _host(hc, "hc_msm_wsum", want.shape, _p(MP.consts_words(spec)),
                _p(red), (J, S))
    assert np.array_equal(got, want.numpy())
    assert not got[J // 2, 2].any()                 # the empty job: identity
    assert torch.equal(MP.msm_wsum(spec, torch.from_numpy(
        red.view(np.int32))), want)                 # CPU wrapper: plain


def test_to_affine_block_replay_vs_plain(hc):
    """K4's batch inversion under g++ (each thread's running products, the
    block's prefix and suffix scans and its one inversion, the back-walk)
    == the Fermat plain version, bit for bit, over 2 1/4 blocks: Z = 0 at
    one point, at every point of one thread of block 0, at every point of
    block 1, and at every point of a thread of the last block, which ends
    mid-thread. A Z of 0 gives (0, 0)."""
    spec = C.PALLAS
    T, c, blk = MP.AFFINE_THREADS, MP.AFFINE_PER_THREAD, MP.AFFINE_BLOCK
    n = 2 * blk + 3 * T + 9                     # thread t < 9 of block 2 has 4
    rng = np.random.default_rng(12)
    pts = _random_points(rng, spec.base, (n,))              # (n, 3, 8)
    zero = [5] + [k * T + 7 for k in range(c)] + list(range(blk, 2 * blk)) \
        + [2 * blk + k * T + 3 for k in range(4)]
    pts[zero, 2] = 0
    X, Y, Z = (np.ascontiguousarray(pts[:, i]) for i in range(3))
    x_h, y_h = np.zeros_like(X), np.zeros_like(Y)
    hc.hc_to_affine(_p(MP.consts_words(spec)), _p(X), _p(Y), _p(Z),
                    _p(x_h), _p(y_h), ctypes.c_longlong(n))
    xp, yp = MP.to_affine_words_plain(spec, *(torch.from_numpy(a.view(
        np.int32)) for a in (X, Y, Z)))
    assert np.array_equal(x_h.view(np.int32), xp.numpy())
    assert np.array_equal(y_h.view(np.int32), yp.numpy())
    assert not x_h[zero].any() and not y_h[zero].any()
    live = np.ones(n, bool)
    live[zero] = False
    assert x_h[live].any(axis=1).all()


# ---------------------------------------------------------------------------
# The field-multiply kernels' bodies (csrc/mont.cuh).
# ---------------------------------------------------------------------------

MONT_FIELDS = ["pallas_base", "vesta_base", "bn254_base"]
LL = ctypes.c_longlong


def _mont_inputs(spec, n, seed):
    """(n, 32) int32 numpy digits of canonical elements, edge lanes 0 * 0,
    (p-1)^2 and 1 * (p-1) first, and the values as ints."""
    rng = np.random.default_rng(seed)
    avs, bvs = ([int.from_bytes(rng.bytes(32), "little") % spec.p
                 for _ in range(n)] for _ in range(2))
    avs[:3], bvs[:3] = [0, spec.p - 1, 1], [0, spec.p - 1, spec.p - 1]
    return spec.batch_to_limbs(avs), spec.batch_to_limbs(bvs), avs, bvs


def _mont_host(hc, spec, a, b, n, layout, shape):
    """The mont_mul kernel's host replay on operands in `layout`: the tiled
    element-major kernel, or the per-element body for the other two."""
    out = np.zeros(shape, np.int32)
    per = 8 if layout == PF.WORDS else 32
    args = (_p(PF.field_consts_words(spec)), _p(a), LL(a.size // per), _p(b),
            LL(b.size // per), _p(out), LL(n))
    if layout == PF.EM:
        hc.hc_mont_mul_em_tiled(*args)
    else:
        hc.hc_mont_mul_fmt(*args, layout)
    return out


@pytest.mark.parametrize("name", MONT_FIELDS)
def test_mont_mul_body_in_every_format(hc, name):
    """K5's load, pack, CIOS product and store, element-major (the kernel's
    shared-memory tiles replayed, two full ones and a part), limb-major and
    on words == the plain version and Python ints; a constant on either
    side and a repeated block as broadcast operands."""
    spec = F.FIELDS[name]
    n = 293
    a, b, avs, bvs = _mont_inputs(spec, n, seed=len(name))
    want = PF.mont_mul_em_plain(spec, torch.from_numpy(a),
                                torch.from_numpy(b)).numpy()
    rinv = pow(1 << 256, -1, spec.p)
    assert F.to_ints(spec, torch.from_numpy(want)) == \
        [x * y * rinv % spec.p for x, y in zip(avs, bvs)]
    assert np.array_equal(_mont_host(hc, spec, a, b, n, PF.EM, (n, 32)), want)
    at, bt = np.ascontiguousarray(a.T), np.ascontiguousarray(b.T)
    assert np.array_equal(_mont_host(hc, spec, at, bt, n, PF.LM, (32, n)),
                          want.T)
    aw = np.ascontiguousarray(F.digits_to_words(torch.from_numpy(a)).numpy())
    bw = np.ascontiguousarray(F.digits_to_words(torch.from_numpy(b)).numpy())
    got = _mont_host(hc, spec, aw, bw, n, PF.WORDS, (n, 8))
    assert np.array_equal(
        got, PF.mont_mul_words_plain(spec, torch.from_numpy(aw),
                                     torch.from_numpy(bw)).numpy())
    assert np.array_equal(F.words_to_digits(torch.from_numpy(got)).numpy(),
                          want)
    # broadcast: b one constant (to_mont's R^2), then b a block of 5
    # elements repeated along the leading axis of a (7, 5, 32) operand
    r2 = np.ascontiguousarray(spec.r2_limbs)
    assert np.array_equal(
        _mont_host(hc, spec, a, r2, n, PF.EM, (n, 32)),
        F.to_mont(spec, torch.from_numpy(a)).numpy())
    assert np.array_equal(
        _mont_host(hc, spec, r2, a, n, PF.EM, (n, 32)),
        F.to_mont(spec, torch.from_numpy(a)).numpy())
    a35, b5 = np.ascontiguousarray(a[:35]), np.ascontiguousarray(b[:5])
    assert np.array_equal(
        _mont_host(hc, spec, a35, b5, 35, PF.EM, (35, 32)).reshape(7, 5, 32),
        PF.mont_mul_em_plain(spec, torch.from_numpy(a35).reshape(7, 5, 32),
                             torch.from_numpy(b5)).numpy())


@pytest.mark.parametrize("name", MONT_FIELDS)
def test_stage_and_part_bodies_vs_plain(hc, name):
    """K10's five stages and K11a's three parts, per-thread code == the
    digit-serial plain versions, element for element; stage 5 == K5."""
    spec = F.FIELDS[name]
    n = 41
    a, b, _, _ = _mont_inputs(spec, n, seed=5)
    # norm: 255 a + b below p, equal to p, and above it
    a[3:6], b[3:6] = 0, spec.batch_to_limbs([spec.p - 1, 0, 7])
    b[4] = spec.p_limbs
    at, bt = np.ascontiguousarray(a.T), np.ascontiguousarray(b.T)
    A, B = torch.from_numpy(at), torch.from_numpy(bt)
    cw = PF.field_consts_words(spec)
    for stage in PF.STAGES:
        out = np.zeros_like(at)
        hc.hc_mont_mul_stage(_p(cw), _p(at), _p(bt), _p(out), LL(n), stage)
        assert np.array_equal(
            out, PF.mont_mul_stage_plain(spec, A, B, stage).numpy()), stage
    assert np.array_equal(out, PF.mont_mul_lm_plain(spec, A, B).numpy())
    for i, part in enumerate(PF.PARTS):
        out = np.zeros_like(at)
        hc.hc_mont_mul_part(_p(cw), _p(at), _p(bt), _p(out), LL(n), i)
        assert np.array_equal(
            out, PF.mont_mul_part_plain(spec, A, B, part).numpy()), part


def _rand_points(spec, rng, n):
    return [C.host_scalar_mul(spec, 1 + int(rng.integers(1 << 62)),
                              spec.gen) for _ in range(n)]


@pytest.mark.parametrize("name", ["pallas", "bn254"])
def test_scale16_body_vs_plain_and_host(hc, name):
    """scale16's per-thread code == its plain version bit for bit
    (the same doublings in the same order), == 16^w P on the host; the
    identity stays the identity."""
    spec = C.CURVES[name]
    pts = _rand_points(spec, np.random.default_rng(9), 5)
    pts[2] = None
    P = MP.point_words(C.affine_to_mont(spec, pts))
    w4 = 6
    out = np.zeros((w4,) + tuple(P.shape), np.uint32)
    hc.hc_scale16(_p(MP.consts_words(spec)),
                  _p(np.ascontiguousarray(P.numpy().view(np.uint32))),
                  _p(out), LL(len(pts)), w4)
    plain = MP.scale16_plain(spec, P, w4)
    assert np.array_equal(out.view(np.int32), plain.numpy())
    got = C.pt_to_affine_host(spec, MP.words_point(plain.reshape(-1, 3, 8)))
    want = []
    for w in range(w4):
        want += [C.host_scalar_mul(spec, 16 ** w, p) for p in pts]
    assert got == want


@pytest.mark.parametrize("name", ["pallas", "bn254"])
def test_h_tables_body_vs_plain_and_host(hc, name):
    """h_tables' per-lane walks, K3's lane schedule and the halves' add
    under g++ == its plain version bit for bit, on seeded rows of random
    full-width, small, negated and zero values over a 16-generator key
    (rows of 0, 1, 2 and 61 nonzeros, an empty row last); the affine
    tables == sum v G on the host."""
    from hotproofs_tpu_torch.ops import tables as TB
    spec = C.CURVES[name]
    fs, n = spec.scalar, 16
    rng = np.random.default_rng(3)
    gens = _rand_points(spec, rng, n)
    b, lpw, w4, _ = MP.plan(n, 256)
    xa, ya = MP.scaled_affine_host(spec, gens, w4)
    bl = MP.lane_major(MP.bases_tm(torch.from_numpy(xa),
                                   torch.from_numpy(ya), n, 256))
    lens = [0, 1, 2, 61] + [int(k) for k in rng.integers(0, 9, 28)] + [0]
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = rng.integers(0, n, len(rows))
    vals = [int.from_bytes(rng.bytes(32), "little") % fs.p
            for _ in range(len(rows))]
    for i, v in zip(range(0, len(vals), 5), (1, fs.p - 1, 0, 15, fs.p - 16,
                                              (fs.p - 1) // 2,
                                              (fs.p + 1) // 2)):
        vals[i] = v
    mont = F.to_h16(F.to_mont(fs, F.from_ints(fs, vals)))
    R = len(lens)
    csr = TB.table_csr(fs, [(torch.from_numpy(rows), torch.from_numpy(cols),
                             mont)], R)
    out = np.zeros((R, 3, 8), np.uint32)
    u32 = lambda t: np.ascontiguousarray(t.numpy().view(np.uint32))
    hc.hc_h_tables(_p(MP.consts_words(spec)), _p(csr.row_ptr.numpy()),
                   _p(csr.order.numpy()), _p(csr.cols.numpy()),
                   _p(u32(csr.mag)), _p(csr.neg.numpy()), _p(u32(bl)),
                   _p(out), R, b, lpw)
    plain = TB.h_tables_plain(spec, csr, bl, lpw)
    assert np.array_equal(out.view(np.int32), plain.numpy())
    got = C.pt_to_affine_host(spec, MP.words_point(plain))
    want = [None] * R
    for r, c, v in zip(rows, cols, vals):
        want[r] = C.host_add(spec, want[r],
                             C.host_scalar_mul(spec, v, gens[c]))
    assert got == want and want[0] is None and want[-1] is None
