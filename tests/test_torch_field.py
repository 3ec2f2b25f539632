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


@pytest.mark.parametrize("name", ["pallas_scalar", "bn254_base"])
def test_square_select_and_predicates_vs_reference(name):
    """mont_square, select, is_zero and eq against the reference's on the
    same digits (zero elements, equal pairs, a batch of two axes)."""
    import jax

    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    xs, ys = _inputs(spec, seed=11, n=24)
    ys[4:8] = xs[4:8]                           # equal pairs
    xs[8] = ys[9] = 0                           # zeros
    a_np = spec.batch_to_limbs(xs).reshape(4, 6, 32)
    b_np = spec.batch_to_limbs(ys).reshape(4, 6, 32)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    sq = jax.jit(lambda x: RF.mont_square(rspec, x))(a_np)
    assert np.array_equal(F.mont_square(spec, a).numpy(), np.asarray(sq))
    mask_np = np.random.default_rng(3).integers(0, 2, (4, 6)).astype(bool)
    for mask in (mask_np, mask_np.astype(np.int32)):
        got = F.select(torch.from_numpy(mask), a, b)
        assert np.array_equal(got.numpy(),
                              np.asarray(RF.select(mask, a_np, b_np)))
    for fn, args in ((F.is_zero, (a,)), (F.is_zero, (b,)),
                     (F.eq, (a, b)), (F.eq, (a, a))):
        got = fn(*args)
        want = getattr(RF, fn.__name__)(*(x.numpy() for x in args))
        assert got.dtype == torch.bool and got.shape == (4, 6)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(F.is_zero(a).sum()) == xs.count(0)
    assert int(F.eq(a, b).sum()) == sum(x == y for x, y in zip(xs, ys))


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


@pytest.mark.parametrize("name", ["pallas_scalar", "vesta_base", "bn254_base"])
def test_public_mul_dispatch_broadcast_and_strides(name):
    """mont_mul, to_mont and from_mont go through the kernel wrapper
    (ops/pallas_field.mont_mul_em): on CPU tensors that is the half-word
    code, whatever the operands' strides and broadcasting (the prover
    multiplies a (32,) u by (n_cons, 32) rows, and strided views of
    stacked batches)."""
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    xs, ys = _inputs(spec, seed=21, n=48)
    a_np, b_np = spec.batch_to_limbs(xs), spec.batch_to_limbs(ys)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    mul = RF.jitted("mul", rspec)
    assert torch.equal(F.mont_mul(spec, a, b), F.mont_mul_plain(spec, a, b))
    # one element against a batch, as relaxed_satisfied's u * Cz
    got = F.mont_mul(spec, b[5][None], a)
    assert np.array_equal(got.numpy(), np.asarray(
        mul(np.broadcast_to(b_np[5], a_np.shape).copy(), a_np)))
    # a strided view of a stacked batch, as the fold loop's az_b[:, k]
    stacked = torch.stack([a, b], dim=1)               # (48, 2, 32)
    got = F.mont_mul(spec, stacked[:, 1], stacked[:, 0])
    assert np.array_equal(got.numpy(), np.asarray(mul(b_np, a_np)))
    batch = a.reshape(4, 12, 32)
    for op in ("to_mont", "from_mont"):
        got = getattr(F, op)(spec, batch)
        assert got.shape == batch.shape and got.dtype == torch.int32
        assert np.array_equal(got.reshape(48, 32).numpy(),
                              np.asarray(RF.jitted(op, rspec)(a_np)))


@pytest.mark.parametrize("name", ["pallas_base", "bn254_scalar"])
def test_batch_limb_conversions_match_the_per_element_loop(name):
    """batch_to_limbs and limbs_to_ints (one byte string a batch) against
    the per-element int_to_limbs / limbs_to_int loop they replaced and the
    reference's spec: values past p and negative ones reduce, and digits
    outside a byte still sum with their weights."""
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    rng = np.random.default_rng(7)
    xs = [int.from_bytes(rng.bytes(33), "little") for _ in range(200)] \
        + [0, 1, spec.p - 1, spec.p, spec.p + 5, -3, -spec.p - 1]
    got = spec.batch_to_limbs(xs)
    want = np.stack([F.int_to_limbs(x % spec.p) for x in xs])
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, rspec.batch_to_limbs(xs))
    back = spec.limbs_to_ints(got.reshape(3, -1, F.N_LIMBS)[:, :69])
    loop = [F.limbs_to_int(r) for r in got.reshape(3, -1, F.N_LIMBS)[:, :69]
            .reshape(-1, F.N_LIMBS)]
    assert back.shape == (3, 69) and list(back.ravel()) == loop
    wide = got[:10].astype(np.int64) * 300 - 7       # not digits of a byte
    assert list(spec.limbs_to_ints(wide)) == \
        [F.limbs_to_int(r) for r in wide] == list(rspec.limbs_to_ints(wide))
    assert spec.batch_to_limbs([]).shape == (0, F.N_LIMBS)
