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
from hotproofs_tpu_torch.ops import poseidon as P
from torch_table_edges import edge_tables

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
             2: C.pt_neg(spec, P)}
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
    H = MP.chain_split(2, n_lanes, b)
    assert H == b
    assert np.array_equal(_host(hc, "hc_msm_chain", ch.shape,
                                _p(MP.lean_consts_words(spec)), _p(bn),
                                (2, b, n_lanes, H)), ch.numpy())

    lm = np.ascontiguousarray(MP.lane_major(bases).numpy())
    d = MP.digits_tm(sc, m, b, lpw, w4)
    dn = np.ascontiguousarray(d.numpy())
    for H in (2, 4):
        ts = MP.msm_bucket_tsplit_plain(spec, d, bases, H)
        assert ts.shape == (2, MP.NBUCKET, 3, 8, H * n_lanes)
        assert np.array_equal(_host(
            hc, "hc_msm_bucket_tsplit", ts.shape, _p(cw), _p(dn), _p(lm),
            (2, b, n_lanes, H)), ts.numpy()), H

    sd = MP.signed_digits_tm(sc, m, b, lpw, w4)
    sn = np.ascontiguousarray(sd.numpy())
    sg = MP.msm_bucket_signed_plain(spec, sd, bases)
    sg_h = _host(hc, "hc_msm_bucket_signed", sg.shape, _p(cw), _p(sn),
                 _p(lm), (2, b, n_lanes))
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


def _edge_digits(rng, J: int, B: int, L: int, signed: bool) -> np.ndarray:
    """(J, B, L) sparse digits (about 1 in 10 nonzero) with the walk's edge
    lanes: lane 0 of job 0 nonzero only in the first half of its steps,
    lane 1 only in the second, lane 2 every step at one digit (signed:
    magnitude 8, negative), lane 3 every step nonzero; job 1 all zero.
    Signed digits are mag | neg << 4, mag in 0..8."""
    top = MP.NSIGNED if signed else MP.NBUCKET
    d = rng.integers(1, top + 1, size=(J, B, L))
    if signed:
        d |= rng.integers(0, 2, size=(J, B, L)) << 4
    d *= rng.random((J, B, L)) < 0.1
    half = np.arange(B) < B // 2
    d[0, :, 0] = np.where(half, rng.integers(1, top + 1, size=B), 0)
    d[0, :, 1] = np.where(half, 0, rng.integers(1, top + 1, size=B))
    d[0, :, 2] = MP.NSIGNED | 16 if signed else 7
    d[0, :, 3] = rng.integers(1, top + 1, size=B)
    d[1] = 0
    return np.ascontiguousarray(d.astype(np.int32))


@pytest.mark.parametrize("design,H", [("tsplit", 1), ("tsplit", 2),
                                      ("tsplit", 4), ("tsplit", 64),
                                      ("signed", 1)])
def test_split_walk_vs_plain_on_edge_digits(hc, design, H):
    """The t-split's and the signed kernel's walk (bucket_walk over a step
    range, and over signed digits) under g++ == their plain versions, bit
    for bit, at the kernel's largest B = 64 and H = 1, 2, 4 and 64 (one
    step a set): lanes whose digits all fall in one half of the range, a
    lane of one repeated digit (signed: every digit magnitude 8 and
    negative), a lane with every step nonzero, an all-zero job. H = 1 also
    equals hc_msm_bucket, the main path's walk."""
    spec = C.PALLAS
    rng = np.random.default_rng(H + (design == "signed"))
    J, B, L = 3, MP.BUCKET_MAX_STEPS, 37
    d = _edge_digits(rng, J, B, L, design == "signed")
    tm = torch.from_numpy(np.ascontiguousarray(_random_points(
        rng, spec.base, (B, L))[:, :, :2].transpose(0, 2, 3, 1)).view(
            np.int32))                                        # (B, 2, 8, L)
    lm = MP.lane_major(tm).numpy()
    cw = MP.consts_words(spec)
    dt = torch.from_numpy(d)
    if design == "signed":
        want = MP.msm_bucket_signed_plain(spec, dt, tm)
        got = _host(hc, "hc_msm_bucket_signed", want.shape, _p(cw), _p(d),
                    _p(lm), (J, B, L))
    else:
        want = MP.msm_bucket_tsplit_plain(spec, dt, tm, H)
        got = _host(hc, "hc_msm_bucket_tsplit", want.shape, _p(cw), _p(d),
                    _p(lm), (J, B, L, H))
    assert np.array_equal(got, want.numpy())
    assert not got[1, :, 2].any()                   # the zero job: identity
    if design == "tsplit" and H == 1:
        walk = _host(hc, "hc_msm_bucket", want.shape, _p(cw), _p(d), _p(lm),
                     (J, B, L))
        assert np.array_equal(got, walk)
    if design == "tsplit" and H == 2:
        # lane 0's digits all fall in set 0, lane 1's in set 1
        assert not got[0, :, 2, :, L + 0].any() and got[0, :, 2, :, 0].any()
        assert not got[0, :, 2, :, 1].any() and got[0, :, 2, :, L + 1].any()


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


@pytest.mark.parametrize("w4", [1, 6])
@pytest.mark.parametrize("name", ["pallas", "vesta", "bn254", "grumpkin"])
def test_scale16_body_vs_plain_and_host(hc, name, w4):
    """scale16's per-thread code (Jacobian doublings on the lean backend's
    host branch, each level's products reduced together) == its plain
    version bit for bit, == 16^w P on the host; a point of Z != 1 in; the
    identity stays (0 : 1 : 0) at every window."""
    spec = C.CURVES[name]
    f = spec.base
    pts = _rand_points(spec, np.random.default_rng(9), 5)
    pts[2] = None
    X, Y, Z = C.affine_to_mont(spec, pts)
    lam = F.from_ints(f, [f.to_mont_int(7)] * 5)   # (7x, 7y, 7) at point 4
    X[4], Y[4], Z[4] = (F.mont_mul(f, c[4:5], lam[4:5])[0] for c in (X, Y, Z))
    P = MP.point_words((X, Y, Z))
    out = np.zeros((w4,) + tuple(P.shape), np.uint32)
    hc.hc_scale16(_p(MP.lean_consts_words(spec)),
                  _p(np.ascontiguousarray(P.numpy().view(np.uint32))),
                  _p(out), LL(len(pts)), w4)
    plain = MP.scale16_plain(spec, P, w4)
    assert np.array_equal(out.view(np.int32), plain.numpy())
    one = F.digits_to_words(torch.from_numpy(f.one_mont_limbs))
    assert not bool(plain[:, 2, 0].any()) and not bool(plain[:, 2, 2].any())
    assert bool((plain[:, 2, 1] == one).all())
    got = C.pt_to_affine_host(spec, MP.words_point(plain.reshape(-1, 3, 8)))
    want = []
    for w in range(w4):
        want += [C.host_scalar_mul(spec, 16 ** w, p) for p in pts]
    assert got == want


@pytest.mark.parametrize("name", ["pallas", "vesta", "bn254", "grumpkin"])
def test_lean_mont_sqr_vs_ints(hc, name):
    """The lean backend's squaring (field_lean.cuh: lean_sqr_wide, the
    cross products once, doubled, plus the squares; then mont_redc<1>, the
    reduction of the low half plus the high half), on its host branch ==
    x^2 / R mod p as integers, with 0, 1, p - 1, (p - 1) / 2, 2^255 - 1
    mod p and words of all ones below p among seeded values; and ==
    mont_mul(x, x). The wide product with the same reduction == x y / R,
    and three reduced in one mont_redc<3> == the integers too."""
    spec = C.CURVES[name]
    f = spec.base
    rng = np.random.default_rng(len(name) + 21)
    xs = [0, 1, f.p - 1, (f.p - 1) // 2, ((1 << 255) - 1) % f.p,
          (1 << (f.p.bit_length() - 1)) - 1] + \
        [int.from_bytes(rng.bytes(32), "little") % f.p for _ in range(58)]
    a = _words(torch.from_numpy(f.batch_to_limbs(xs)))
    lw = MP.lean_consts_words(spec)
    out, mul = np.zeros_like(a), np.zeros_like(a)
    hc.hc_lean_field(_p(lw), _p(a), _p(a), _p(out), len(xs), 4)
    hc.hc_lean_field(_p(lw), _p(a), _p(a), _p(mul), len(xs), 0)
    rinv = pow(1 << 256, -1, f.p)
    assert F.to_ints(f, _digits(out)) == [x * x * rinv % f.p for x in xs]
    assert np.array_equal(out, mul)
    ys = xs[::-1]
    b = _words(torch.from_numpy(f.batch_to_limbs(ys)))
    sos, tri = np.zeros_like(a), np.zeros_like(a)
    hc.hc_lean_field(_p(lw), _p(a), _p(b), _p(sos), len(xs), 5)
    assert F.to_ints(f, _digits(sos)) == [x * y * rinv % f.p
                                          for x, y in zip(xs, ys)]
    hc.hc_lean_field(_p(lw), _p(a), _p(b), _p(tri), len(xs), 6)
    k = len(xs) // 3
    want = [v for x, y in zip(xs[:k], ys[:k])
            for v in (x * x * rinv % f.p, y * y * rinv % f.p,
                      x * y * rinv % f.p)]
    assert F.to_ints(f, _digits(tri[:3 * k])) == want


def _toeplitz(b):
    """T_b[c][j] = b_{c-j} (0 above the diagonal), as numpy."""
    c, j = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    return np.where(c >= j, np.asarray(b)[np.clip(c - j, 0, 31)], 0)


@pytest.mark.parametrize("digits", ["seeded", "all 255", "edges"])
def test_conv_mma_fragments_spell_toeplitz(hc, digits):
    """conv_mma's own fragment functions (conv_mma.cuh: the staging's packed
    and reversed words, the byte-permuted windows) under a host model of
    m16n8k32's u8 layout (A 16 x 32 row-major per m-tile, B 32 x 8
    col-major, C/D 16 x 8): the A it spells is T_b, every column of B is a,
    and the accumulator each lane stores gives every conv column once."""
    rng = np.random.default_rng(31)
    if digits == "seeded":
        a, b = (rng.integers(0, 256, 32) for _ in range(2))
    elif digits == "all 255":
        a = b = np.full(32, 255)
    else:                       # one digit set at either end of each
        a, b = np.zeros(32, np.int64), np.zeros(32, np.int64)
        a[[0, 31]], b[[0, 31]] = (255, 1), (1, 255)
    a, b = (np.ascontiguousarray(x, np.int32) for x in (a, b))
    A = np.zeros((32, 32), np.uint8)
    B = np.zeros((32, 8), np.uint8)
    cols = np.zeros(32, np.int32)
    hc.hc_conv_frags(_p(a), _p(b), _p(A), _p(B), _p(cols))
    assert np.array_equal(A, _toeplitz(b))
    assert np.array_equal(B, np.repeat(a[:, None], 8, axis=1))
    want = [sum(int(a[j]) * int(b[c - j]) for j in range(c + 1))
            for c in range(32)]
    assert cols.tolist() == want
    if digits == "all 255":
        assert want[31] == 32 * 255 ** 2       # the largest column


def test_conv_mma_kernel_replay_vs_plain(hc):
    """k_conv_mma's blocks replayed under g++ (staging, fragments, the mma
    model, staging out) == conv_mma_plain == the conv part's columns,
    at n = 300 (two full tiles and a part) with all-255 and zero
    elements among seeded digits."""
    spec = F.pallas_base
    n = 300
    a, b, _, _ = _mont_inputs(spec, n, seed=23)
    a[5], b[5] = 255, 255
    a[6] = 0
    at, bt = np.ascontiguousarray(a.T), np.ascontiguousarray(b.T)
    out = np.full_like(at, -7)
    hc.hc_conv_mma(_p(at), _p(bt), _p(out), LL(n))
    plain = PF.conv_mma_plain(torch.from_numpy(at), torch.from_numpy(bt))
    assert np.array_equal(out, plain.numpy())
    assert torch.equal(plain & 0xFF, PF.mont_mul_part_plain(
        spec, torch.from_numpy(at), torch.from_numpy(bt), "conv"))
    assert int(plain[31, 5]) == 32 * 255 ** 2 and not plain[:, 6].any()


@pytest.mark.parametrize("name", ["pallas", "bn254"])
def test_h_tables_body_vs_plain_and_host(hc, name):
    """h_tables' per-lane walks, the parts' trees, the gather and K3's
    lane schedule under g++ == its plain version bit for bit, on seeded
    rows of random full-width, small, negated and zero values over a
    16-generator key (rows of 0, 1, 2 and 61 nonzeros, an empty row
    last); the affine tables == sum v G on the host."""
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
    hc.hc_h_tables(_p(MP.lean_consts_words(spec)), _p(csr.row_ptr.numpy()),
                   _p(csr.order.numpy()), _p(csr.alloc.numpy()),
                   _p(csr.cols.numpy()), _p(u32(csr.mag)),
                   _p(csr.neg.numpy()), _p(u32(bl)), _p(out), R, b, lpw)
    plain = TB.h_tables_plain(spec, csr, bl, lpw)
    assert np.array_equal(out.view(np.int32), plain.numpy())
    got = C.pt_to_affine_host(spec, MP.words_point(plain))
    want = [None] * R
    for r, c, v in zip(rows, cols, vals):
        want[r] = C.host_add(spec, want[r],
                             C.host_scalar_mul(spec, v, gens[c]))
    assert got == want and want[0] is None and want[-1] is None


@pytest.mark.parametrize("name", ["pallas", "vesta", "bn254", "grumpkin"])
def test_lean_field_ops_vs_ints(hc, name):
    """The lean backend's host branch (field_lean.cuh): mont_mul, fe_add,
    fe_sub and the product by 3b through its small signed constant (15,
    15, 9, -51) == the integers, edge values included."""
    spec = C.CURVES[name]
    f = spec.base
    rng = np.random.default_rng(len(name) + 7)
    xs = [int.from_bytes(rng.bytes(32), "little") % f.p for _ in range(64)]
    ys = [int.from_bytes(rng.bytes(32), "little") % f.p for _ in range(64)]
    xs[:4], ys[:4] = [0, f.p - 1, f.p - 1, 1], [f.p - 1, f.p - 1, 0, 0]
    a = _words(torch.from_numpy(f.batch_to_limbs(xs)))
    b = _words(torch.from_numpy(f.batch_to_limbs(ys)))
    lw = MP.lean_consts_words(spec)
    assert lw[-1].view(np.int32) == MP.b3_small(spec)
    rinv = pow(1 << 256, -1, f.p)
    k = 3 * spec.b % f.p
    for op, want in enumerate(([x * y * rinv for x, y in zip(xs, ys)],
                               [x + y for x, y in zip(xs, ys)],
                               [x - y for x, y in zip(xs, ys)],
                               [k * x for x in xs])):
        out = np.zeros_like(a)
        hc.hc_lean_field(_p(lw), _p(a), _p(b), _p(out), len(xs), op)
        assert F.to_ints(f, _digits(out)) == [w % f.p for w in want], op


@pytest.mark.parametrize("name", ["pallas", "vesta", "bn254", "grumpkin"])
def test_lean_point_ops_vs_plain(hc, name):
    """pt_add and pt_add_mixed on the lean backend (the products by 3b as
    additions) == the plain versions bit for bit, the identity and a
    doubling included; == the host's sums as affine points."""
    spec = C.CURVES[name]
    rng = np.random.default_rng(11)
    pts = _rand_points(spec, rng, 12)
    qts = _rand_points(spec, rng, 12)
    pts[0] = None
    pts[1] = qts[1]
    pts[2] = (qts[2][0], (-qts[2][1]) % spec.base.p)
    P, Q = C.affine_to_mont(spec, pts), C.affine_to_mont(spec, qts)
    lw = MP.lean_consts_words(spec)
    pw, qw = _proj_words(P), _proj_words(Q)
    for op, want in ((0, C.pt_add(spec, P, Q)),
                     (1, C.pt_add_mixed(spec, P, (Q[0], Q[1])))):
        out = np.zeros_like(pw)
        hc.hc_lean_point_op(_p(lw), _p(pw), _p(qw), _p(out), len(pts), op)
        got = tuple(_digits(out[:, c]) for c in range(3))
        for g, w in zip(got, want):
            assert torch.equal(g, w), op
        assert C.pt_to_affine_host(spec, got) == [
            C.host_add(spec, p, q) for p, q in zip(pts, qts)]


@pytest.mark.parametrize("H", [1, 2, 4, 32])
def test_chain_body_vs_plain_at_every_split(hc, H):
    """msm_chain's sub-chains and shuffle tree (chain_part, chain_join)
    under g++ == msm_chain_plain bit for bit at H = 1, 2, 4 and 32 (the
    widest tree in one warp) over B = 64 steps; every H gives the same
    affine lane sums; a B that H does not divide, an H that is no power of
    two or too wide, are refused by the wrapper."""
    spec = C.PALLAS
    L, B = 24, 64
    pts, p = [], None
    for _ in range(B * L):                  # G, 2G, 3G, ...: curve points
        p = C.host_add(spec, p, spec.gen)
        pts.append(p)
    X, Y, _ = C.affine_to_mont(spec, pts)
    bases = torch.stack([F.digits_to_words(X), F.digits_to_words(Y)],
                        dim=1).reshape(B, L, 2, 8).permute(0, 2, 3, 1) \
        .contiguous()                       # (B, 2, 8, L)
    bn = np.ascontiguousarray(bases.numpy().view(np.uint32))
    ch = MP.msm_chain_plain(spec, bases, 2, H)
    got = _host(hc, "hc_msm_chain", ch.shape, _p(MP.lean_consts_words(spec)),
                _p(bn), (2, B, L, H))
    assert np.array_equal(got, ch.numpy())
    assert torch.equal(ch, MP.msm_chain(spec, bases, 2, H))
    lanes = lambda c: C.pt_to_affine_host(spec, MP.words_point(
        c[0].permute(2, 0, 1).contiguous()))
    assert lanes(ch) == lanes(MP.msm_chain_plain(spec, bases, 1, 1))
    for bad in (3, 64):
        with pytest.raises(ValueError):
            MP.msm_chain(spec, bases, 1, bad)
    with pytest.raises(ValueError):
        MP.msm_chain(spec, bases[:48], 1, 32)


@pytest.mark.parametrize("name", ["pallas", "grumpkin"])
def test_h_tables_lane_map_edges(hc, name):
    """h_tables' balanced lane map under g++ == its plain version bit for
    bit, and == sum v G on the host, on the edge rows of _edge_tables:
    empty rows, one digit, 259 full-width negated values, all lanes on one
    digit value; Grumpkin's 3b = -51 through the lean backend."""
    from hotproofs_tpu_torch.ops import tables as TB
    spec = C.CURVES[name]
    n = 16
    rng = np.random.default_rng(5)
    gens = _rand_points(spec, rng, n)
    b, lpw, w4, _ = MP.plan(n, 256)
    xa, ya = MP.scaled_affine_host(spec, gens, w4)
    bl = MP.lane_major(MP.bases_tm(torch.from_numpy(xa),
                                   torch.from_numpy(ya), n, 256))
    csr, rows, cols, vals = edge_tables(spec, n, rng)
    R = csr.rows
    out = np.zeros((R, 3, 8), np.uint32)
    u32 = lambda t: np.ascontiguousarray(t.numpy().view(np.uint32))
    hc.hc_h_tables(_p(MP.lean_consts_words(spec)), _p(csr.row_ptr.numpy()),
                   _p(csr.order.numpy()), _p(csr.alloc.numpy()),
                   _p(csr.cols.numpy()), _p(u32(csr.mag)),
                   _p(csr.neg.numpy()), _p(u32(bl)), _p(out), R, b, lpw)
    plain = TB.h_tables_plain(spec, csr, bl, lpw)
    assert np.array_equal(out.view(np.int32), plain.numpy())
    got = C.pt_to_affine_host(spec, MP.words_point(plain))
    want = [None] * R
    for r, c, v in zip(rows, cols, vals):
        want[r] = C.host_add(spec, want[r],
                             C.host_scalar_mul(spec, v, gens[c]))
    assert got == want
    assert got[0] is None and got[3] is None and got[14] is None
    assert bool(csr.neg[csr.row_ptr[4]:csr.row_ptr[5]].all())


def test_table_steps_and_alloc_vs_direct_count():
    """ops/tables: lane_alloc gives each present value 1..n_v lanes, 32 at
    most a row, and never leaves a lane spare while a value has more than
    one add a lane; table_steps' walk and join warp-steps == a direct
    count over the lanes of every row (table_lane_map's map, each lane's
    matches counted digit by digit, each join level's adds of two points
    that are not the identity)."""
    from hotproofs_tpu_torch.ops import tables as TB
    spec = C.PALLAS
    csr, _, _, _ = edge_tables(spec, 16, np.random.default_rng(6))
    n = TB.value_counts(csr.row_ptr, csr.mag)
    _, _, _, a, _ = TB.lane_map(csr.alloc)
    assert bool(((a > 0) == (n > 0)).all()) and bool((a <= n).all())
    assert bool((a.sum(dim=1) <= 32).all())
    short = a.sum(dim=1) < 32
    assert bool((TB.row_walk(n, a)[short] <= 1).all())
    assert int(a[4].sum()) == 32 and int(a[5, 0]) == 32
    digits = TB._digits(csr.mag)
    walk = join = 0
    for r in range(csr.rows):
        k0, k1 = int(csr.row_ptr[r]), int(csr.row_ptr[r + 1])
        seq = [int(d) for k in range(k0, k1) for d in digits[k] if d]
        al = [int(x) for x in csr.alloc[r]]
        ab = [(al[v // 4] >> (8 * (v % 4))) & 0xFF for v in range(15)]
        lanes = []
        for lane in range(32):
            s, got = 0, None
            for v in range(1, 16):
                if s <= lane < s + ab[v - 1]:
                    got = (v, lane - s, ab[v - 1])
                s += ab[v - 1]
            lanes.append(got)
        count = [0] * 32
        for lane, m in enumerate(lanes):
            if m:
                v, part, parts = m
                count[lane] = sum(1 for i, d in enumerate(
                    [d for d in seq if d == v]) if i % parts == part)
        walk += max(count)
        live = [c > 0 for c in count]
        off = 1
        while off < max(ab):
            take = [m is not None and m[1] % (2 * off) == 0
                    and m[1] + off < m[2] for m in lanes]
            join += any(take[l] and live[l] and live[l + off]
                        for l in range(32))
            off *= 2
        sl = [any(d == v for d in seq) for v in range(1, 16)] + [False]
        off = 1
        while off < 16:
            prev = list(sl)
            join += any(prev[v] and v + off < 16 and prev[v + off]
                        for v in range(16))
            sl = [prev[v] or (v + off < 16 and prev[v + off])
                  for v in range(16)]
            off *= 2
        off = 8
        while off:
            join += any(sl[v] and sl[v + off] for v in range(off))
            sl = [sl[v] or sl[v + off] if v < off else sl[v]
                  for v in range(16)]
            off //= 2
    assert TB.table_steps(csr) == (walk, join)


# The eight specs of chip_smoke.py's phase 13: the kernel's three widths.
POSEIDON_SPECS = {
    "pallas-default": ("pallas_scalar", 3, False),
    "vesta-default": ("vesta_scalar", 3, False),
    "pallas-neptune": ("pallas_scalar", 3, True),
    "vesta-neptune": ("vesta_scalar", 3, True),
    "bn254": ("bn254_scalar", 3, False),
    "grumpkin": ("grumpkin_scalar", 3, False),
    "pallas-t5": ("pallas_scalar", 5, False),
    "pallas-t9": ("pallas_scalar", 9, False)}


@pytest.mark.parametrize("which", sorted(POSEIDON_SPECS))
def test_poseidon_body_vs_host_permute(hc, which):
    """k_poseidon's per-thread body (csrc/poseidon.cuh) over 7 states, the
    first all 0 and the second all p - 1, == host_permute and the plain
    version, with the constants buffer and field pack the wrapper passes."""
    field, t, neptune = POSEIDON_SPECS[which]
    spec = P.make_spec_neptune(field, t - 1) if neptune \
        else P.make_spec(field, t)
    fld = spec.field
    rng = np.random.default_rng(t + len(which))
    ints = [[int.from_bytes(rng.bytes(32), "little") % fld.p
             for _ in range(t)] for _ in range(7)]
    ints[0], ints[1] = [0] * t, [fld.p - 1] * t
    x = torch.from_numpy(np.stack([fld.batch_to_limbs(
        [fld.to_mont_int(v) for v in row]) for row in ints]))
    xin = np.ascontiguousarray(x.numpy())
    out = np.zeros_like(xin)
    consts = np.ascontiguousarray(
        P._kernel_consts(spec, "cpu").numpy().view(np.uint32))
    fw = PF.field_consts_words(fld)
    assert hc.hc_poseidon(_p(fw), _p(consts), t, spec.r_full,
                          spec.r_partial, _p(xin), _p(out),
                          ctypes.c_longlong(len(ints))) == 0
    got = torch.from_numpy(out)
    assert torch.equal(got, P.permute_plain(spec, x))
    assert [F.to_ints(fld, got[i], mont=True) for i in range(len(ints))] \
        == [P.host_permute(spec, row) for row in ints]


def test_poseidon_body_refuses_other_widths(hc):
    spec = P.make_spec("pallas_scalar", t=4)
    x = np.zeros((1, 4, 32), np.int32)
    consts = np.ascontiguousarray(
        P._kernel_consts(spec, "cpu").numpy().view(np.uint32))
    fw = PF.field_consts_words(spec.field)
    assert hc.hc_poseidon(_p(fw), _p(consts), 4, spec.r_full,
                          spec.r_partial, _p(x), _p(x.copy()),
                          ctypes.c_longlong(1)) == 1
