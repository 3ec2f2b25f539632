"""Port field ops (hotproofs_tpu_torch.ops.field) vs the JAX reference's
XLA field ops and vs Python ints, on all eight fields. Exact equality."""

import numpy as np
import pytest
import torch

from hotproofs_tpu.ops import field as RF
from hotproofs_tpu_torch.ops import field as F

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

FIELD_NAMES = sorted(F.FIELDS)


def _inputs(spec, seed, n=48):
    rng = np.random.default_rng(seed)
    p = spec.p
    xs = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    ys = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    xs[:4] = [0, 1, p - 1, p - 2]
    ys[:4] = [p - 1, 0, p - 1, 1]
    return xs, ys


@pytest.mark.parametrize("name", FIELD_NAMES)
def test_spec_constants_match_reference(name):
    a, b = F.FIELDS[name], RF.FIELDS[name]
    assert (a.p, a.n0inv, a.r_mod_p, a.exp_p_minus_2_bits) == \
        (b.p, b.n0inv, b.r_mod_p, b.exp_p_minus_2_bits)
    for attr in ("p_limbs", "r2_limbs", "one_mont_limbs", "mu_limbs"):
        assert np.array_equal(getattr(a, attr), getattr(b, attr)), attr


@pytest.mark.parametrize("name", FIELD_NAMES)
def test_ops_vs_reference_and_ints(name):
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    p, R = spec.p, 1 << 256
    rinv = pow(R, -1, p)
    xs, ys = _inputs(spec, seed=len(name))
    a_np, b_np = spec.batch_to_limbs(xs), spec.batch_to_limbs(ys)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    cases = {
        "add": (F.add(spec, a, b), (a_np, b_np),
                [x + y for x, y in zip(xs, ys)]),
        "sub": (F.sub(spec, a, b), (a_np, b_np),
                [x - y for x, y in zip(xs, ys)]),
        "neg": (F.neg(spec, a), (a_np,), [-x for x in xs]),
        "mul": (F.mont_mul(spec, a, b), (a_np, b_np),
                [x * y * rinv for x, y in zip(xs, ys)]),
        "to_mont": (F.to_mont(spec, a), (a_np,), [x * R for x in xs]),
        "from_mont": (F.from_mont(spec, a), (a_np,), [x * rinv for x in xs]),
    }
    for op, (got, ref_args, want) in cases.items():
        ref = np.asarray(RF.jitted(op, rspec)(*ref_args))
        assert np.array_equal(got.numpy(), ref), op
        assert F.to_ints(spec, got) == [w % p for w in want], op


@pytest.mark.parametrize("name", ["pallas_base", "vesta_base", "bn254_base"])
def test_inv_vs_reference_and_ints(name):
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    p, R = spec.p, 1 << 256
    xs, _ = _inputs(spec, seed=7, n=8)
    a_np = spec.batch_to_limbs(xs)
    got = F.inv(spec, torch.from_numpy(a_np))
    assert np.array_equal(got.numpy(),
                          np.asarray(RF.jitted("inv", rspec)(a_np)))
    rinv = pow(R, -1, p)
    want = [pow(x * rinv % p, p - 2, p) * R % p for x in xs]
    assert F.to_ints(spec, got) == want


def test_lazy_row_sum_reduction():
    """h_reduce_lazy: an integer sum of many canonical values -> mod p."""
    spec = F.pallas_scalar
    xs, ys = _inputs(spec, seed=3, n=16)
    h = F.to_h16(torch.from_numpy(spec.batch_to_limbs(xs)))
    lazy = h * 1000 + F.to_h16(torch.from_numpy(spec.batch_to_limbs(ys)))
    got = F.from_h16(F.h_reduce_lazy(spec, lazy))
    assert F.to_ints(spec, got) == [(1000 * x + y) % spec.p
                                    for x, y in zip(xs, ys)]


def test_digit_word_repack_roundtrip():
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.integers(0, 256, size=(7, 3, 32),
                                      dtype=np.int32))
    w = F.digits_to_words(d)
    assert w.shape == (7, 3, 8) and w.dtype == torch.int32
    assert torch.equal(F.words_to_digits(w), d)
    assert torch.equal(F.h16_to_words(F.words_to_h16(w)), w)
    assert torch.equal(F.from_h16(F.to_h16(d)), d)
    # word k is the little-endian u32 of digits 4k .. 4k+3
    flat = d.reshape(-1, 32).numpy().astype(np.uint64)
    want = sum(flat[:, np.arange(0, 32, 4) + j] << np.uint64(8 * j)
               for j in range(4))
    assert np.array_equal(w.reshape(-1, 8).numpy().view(np.uint32), want)
