"""The CUDA kernels' arithmetic and per-thread bodies, built for the host.

csrc/field.cuh, csrc/curve.cuh and csrc/msm.cuh compile with g++ when
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
    bn = np.ascontiguousarray(bases.numpy().view(np.uint32))
    bk_h = np.zeros(tuple(bk.shape), np.uint32)
    hc.hc_msm_bucket(_p(cw), _p(dn), _p(bn), _p(bk_h), 2, b, n_lanes)
    assert np.array_equal(bk_h.view(np.int32), bk.numpy())

    red = MP.msm_merge_plain(spec, bk)
    red_h = np.zeros(tuple(red.shape), np.uint32)
    hc.hc_msm_merge(_p(cw), _p(bk_h), _p(red_h), 2, n_lanes)
    assert np.array_equal(red_h.view(np.int32), red.numpy())

    s = MP.msm_wsum_plain(spec, red)
    s_h = np.zeros(tuple(s.shape), np.uint32)
    hc.hc_msm_wsum(_p(cw), _p(red_h), _p(s_h), 2)
    assert np.array_equal(s_h.view(np.int32), s.numpy())


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
