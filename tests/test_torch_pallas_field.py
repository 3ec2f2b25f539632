"""The port's field-multiply wrappers (hotproofs_tpu_torch.ops.pallas_field)
against the JAX package's Pallas field kernels, on the CPU.

The same numpy-seeded inputs go through both sides. The reference's
mont_mul_lm and mont_mul_em run as its own tests run them here, through
the Pallas interpreter; its stage and part kernels live in tools that
cannot be imported (they run at import, at full size, without interpret
mode), so the same compositions of its in-kernel helpers (_conv_rows,
_conv_const_rows, _ks_carry_rows, _cond_sub_rows, mont_mul_rows) are called
as plain jnp functions. The port's wrappers take their plain torch versions
for CPU tensors. Tolerance: none, all values are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotproofs_tpu.ops import field as RF
from hotproofs_tpu.ops import pallas_field as RPF
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import pallas_field as PF
from hotproofs_tpu_torch.tools import field_mul as FM
from hotproofs_tpu_torch.utils import bridge

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

FIELDS = ["pallas_base", "vesta_base", "bn254_base"]
L = 32


def _digits(spec, n, seed):
    """Two (n, 32) numpy digit arrays of canonical elements, with the edge
    lanes 0 * 0, (p-1)^2 and 1 * (p-1) first; and the values as ints."""
    rng = np.random.default_rng(seed)
    avs, bvs = ([int.from_bytes(rng.bytes(32), "little") % spec.p
                 for _ in range(n)] for _ in range(2))
    avs[:3], bvs[:3] = [0, spec.p - 1, 1], [0, spec.p - 1, spec.p - 1]
    return spec.batch_to_limbs(avs), spec.batch_to_limbs(bvs), avs, bvs


@pytest.mark.parametrize("name", FIELDS)
def test_consts_pack_matches_reference(name):
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    w = PF.field_consts_words(spec)
    assert w.shape == (17,) and w.dtype == np.uint32
    ref = RPF.field_consts(rspec)                     # (33, 2): p, mu
    as_digits = lambda words: np.ascontiguousarray(words).view(np.uint8)
    assert np.array_equal(as_digits(w[:8]), ref[:L, 0])
    assert np.array_equal(as_digits(w[8:16]), ref[:L, 1])
    assert (int(w[16]) * spec.p + 1) % (1 << 32) == 0
    for which, col in (("p", 0), ("mu", 1)):
        assert np.array_equal(PF.const_digits(spec, which, "cpu").numpy(),
                              ref[:L, col])


@pytest.mark.parametrize("name", FIELDS)
def test_mont_mul_lm_vs_reference(name):
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    n = RPF.N_LANES
    a, b, avs, bvs = _digits(spec, n, seed=len(name))
    ref = np.asarray(RPF.mont_mul_lm(rspec, jnp.asarray(a.T.copy()),
                                     jnp.asarray(b.T.copy())))
    got = PF.mont_mul_lm(spec, bridge.tensor(a.T), bridge.tensor(b.T))
    assert got.shape == (L, n) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    rinv = pow(1 << 256, -1, spec.p)
    for i in list(range(3)) + list(range(3, n, 37)):
        assert F.limbs_to_int(got[:, i].numpy()) == \
            avs[i] * bvs[i] * rinv % spec.p
    # the word entry point holds the same values
    w = PF.mont_mul_words(spec, F.digits_to_words(bridge.tensor(a)),
                          F.digits_to_words(bridge.tensor(b)))
    assert np.array_equal(F.words_to_digits(w).numpy(), ref.T)


@pytest.mark.parametrize("name", FIELDS)
def test_mont_mul_em_vs_reference_with_broadcast(name):
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    n = 70                                            # not a lane multiple
    a, b, _, _ = _digits(spec, n, seed=7)
    ref = np.asarray(RPF.mont_mul_em(rspec, jnp.asarray(a), jnp.asarray(b)))
    got = PF.mont_mul_em(spec, bridge.tensor(a), bridge.tensor(b))
    assert np.array_equal(got.numpy(), ref)
    # a constant operand, and one row block repeated along a leading axis
    cases = [(a.reshape(2, 35, L), b[0]), (a.reshape(2, 35, L), b[:35]),
             (a[:35][None], b.reshape(2, 35, L)),
             (a.reshape(2, 35, L), b[:2].reshape(2, 1, L))]
    for x, y in cases:
        ref = np.asarray(RPF.mont_mul_em(rspec, jnp.asarray(x),
                                         jnp.asarray(y)))
        got = PF.mont_mul_em(spec, bridge.tensor(x), bridge.tensor(y))
        assert got.shape == ref.shape
        assert np.array_equal(got.numpy(), ref)


def _ref_stage(rspec, a, b, stage):
    """The five prefixes of the reference's all-VPU mont_mul_rows
    (pallas_field.py, legacy branch), as tools/bench_pallas_bisect.py cuts
    them, on (32, N) jnp digit tiles."""
    consts = jnp.asarray(RPF.field_consts(rspec))
    p_ext, mu = consts[:, 0:1], consts[:L, 1:2]
    t = RPF._ks_carry_rows(RPF._conv_rows(a, b, 2 * L))
    if stage == 1:
        return t[:L]
    m = RPF._ks_carry_rows(RPF._conv_const_rows(t[:L], mu, L))
    if stage == 2:
        return m
    mp = RPF._conv_const_rows(m, p_ext[:L], 2 * L)
    if stage == 3:
        return (t + mp)[:L]
    if stage == 4:
        u = jnp.pad(t + mp, ((0, 1), (0, 0)))
        return RPF._ks_carry_rows(u)[L:][:L]
    return RPF.mont_mul_rows(consts, a, b)


@pytest.mark.parametrize("stage", PF.STAGES)
@pytest.mark.parametrize("name", FIELDS)
def test_stage_vs_reference_composition(name, stage):
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    a, b, _, _ = _digits(spec, 128, seed=11)
    at, bt = a.T.copy(), b.T.copy()
    ref = np.asarray(_ref_stage(rspec, jnp.asarray(at), jnp.asarray(bt),
                                stage))
    got = PF.mont_mul_stage(spec, bridge.tensor(at), bridge.tensor(bt), stage)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    if stage == 5:
        assert torch.equal(got, PF.mont_mul_lm(spec, bridge.tensor(at),
                                               bridge.tensor(bt)))


def _ref_part(rspec, a, b, part):
    """k_conv, k_conv3 and k_norm of tools/bench_pallas_parts.py as plain
    jnp, with the constants as the package packs them (p in column 0, mu
    in column 1)."""
    consts = jnp.asarray(RPF.field_consts(rspec))
    p_ext, mu = consts[:, 0:1], consts[:L, 1:2]
    if part == "conv":
        return RPF._conv_rows(a, b, 2 * L)[:L] & 0xFF
    if part == "conv3":
        t = RPF._conv_rows(a, b, 2 * L)
        m = RPF._conv_const_rows(t[:L] & 0xFF, mu, L)
        mp = RPF._conv_const_rows(m & 0xFF, p_ext[:L], 2 * L)
        return (t + mp)[:L]
    t = RPF._ks_carry_rows(jnp.pad(a * 255 + b, ((0, L), (0, 0))))
    return RPF._cond_sub_rows(t[:L + 1], p_ext)[:L]


@pytest.mark.parametrize("part", PF.PARTS)
@pytest.mark.parametrize("name", FIELDS)
def test_part_vs_reference_composition(name, part):
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    a, b, _, _ = _digits(spec, 128, seed=13)
    if part == "norm":
        # 255 a + b around p: below, equal, just above, and far above
        a[3:7], b[3:7] = 0, spec.batch_to_limbs([spec.p - 1, 0, 1, 5])
        a[4, :] = 0
        b[4] = spec.p_limbs
        a[5], b[5] = spec.batch_to_limbs([1]), spec.batch_to_limbs(
            [spec.p - 254])
    at, bt = a.T.copy(), b.T.copy()
    ref = np.asarray(_ref_part(rspec, jnp.asarray(at), jnp.asarray(bt), part))
    got = PF.mont_mul_part(spec, bridge.tensor(at), bridge.tensor(bt), part)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", FIELDS)
def test_conv_mma_plain_vs_conv_part_and_reference(name):
    spec, rspec = F.FIELDS[name], RF.FIELDS[name]
    a, b, _, _ = _digits(spec, 41, seed=17)
    at, bt = bridge.tensor(a.T), bridge.tensor(b.T)
    got = PF.conv_mma(at, bt)
    assert torch.equal(got & 0xFF, PF.mont_mul_part(spec, at, bt, "conv"))
    ref = RPF._conv_rows(jnp.asarray(a.T.copy()), jnp.asarray(b.T.copy()),
                         2 * L)[:L]
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", FIELDS)
def test_conv_mma_plain_vs_reference_conv_part_interpret(name):
    """conv_mma_plain, the Toeplitz formulation (col = T_b a), against the
    reference's conv part as a Pallas kernel through the interpreter: the
    body of tools/bench_pallas_parts.py's k_conv over one block of the
    package's lane width, without its & 0xFF (the lazy columns) and with
    it (the conv part); all-255 elements among the seeded ones."""
    import jax
    from jax.experimental import pallas as pl
    spec = F.FIELDS[name]
    n = RPF.N_LANES
    a, b, _, _ = _digits(spec, n, seed=19)
    a[7:9], b[7:9] = 255, 255
    at, bt = a.T.copy(), b.T.copy()

    def k_conv(a_ref, b_ref, lazy_ref, conv_ref):
        t = RPF._conv_rows(a_ref[:], b_ref[:], 2 * L)[:L]
        lazy_ref[:] = t
        conv_ref[:] = t & 0xFF

    out = jax.ShapeDtypeStruct((L, n), jnp.int32)
    lazy, conv = pl.pallas_call(k_conv, out_shape=(out, out),
                                interpret=True)(jnp.asarray(at),
                                                jnp.asarray(bt))
    got = PF.conv_mma_plain(bridge.tensor(at), bridge.tensor(bt))
    assert np.array_equal(got.numpy(), np.asarray(lazy))
    assert np.array_equal((got & 0xFF).numpy(), np.asarray(conv))
    assert int(got[L - 1, 7]) == L * 255 ** 2


def test_wrappers_refuse_what_the_kernels_do_not_take():
    spec = F.pallas_base
    a, b, _, _ = _digits(spec, 8, seed=1)
    em, lm = bridge.tensor(a), bridge.tensor(a.T)
    with pytest.raises(TypeError):
        PF.mont_mul_em(spec, em.to(torch.int64), em)
    with pytest.raises(ValueError):
        PF.mont_mul_em(spec, em[:, :31], em[:, :31])
    with pytest.raises(TypeError):
        F.mont_mul(spec, em, em.to(torch.int64))      # the public op too
    for fn in (lambda x, y: PF.mont_mul_lm(spec, x, y),
               lambda x, y: PF.mont_mul_stage(spec, x, y, 5),
               lambda x, y: PF.mont_mul_part(spec, x, y, "conv"),
               PF.conv_mma):
        with pytest.raises(ValueError):
            fn(em, em)                                # element-major layout
        with pytest.raises(ValueError):
            fn(em.T, em.T)                            # not contiguous
        with pytest.raises(ValueError):
            fn(lm, lm[:, :4].contiguous())            # shapes differ
        with pytest.raises(TypeError):
            fn(lm.to(torch.int64), lm)
    with pytest.raises(ValueError):
        PF.mont_mul_words(spec, em, em)
    with pytest.raises(ValueError):
        PF.mont_mul_stage(spec, lm, lm, 6)
    with pytest.raises(ValueError):
        PF.mont_mul_part(spec, lm, lm, "carry")


def test_launch_counts_stay_zero_on_the_cpu():
    spec = F.pallas_base
    a, b, _, _ = _digits(spec, 4, seed=2)
    before = dict(PF.launches)
    F.to_mont(spec, bridge.tensor(a))
    PF.mont_mul_stage(spec, bridge.tensor(a.T), bridge.tensor(b.T), 3)
    PF.conv_mma(bridge.tensor(a.T), bridge.tensor(b.T))
    assert PF.launches == before
    assert {"mont_mul", "mont_mul_stage", "mont_mul_part",
            "conv_mma"} <= set(PF.launches)


def test_host_msm_windowed_equals_host_msm():
    spec = C.PALLAS
    rng = np.random.default_rng(4)
    gens = C.derive_generators(spec, b"test-field-mul", 12)
    ks = [int.from_bytes(rng.bytes(32), "little") >> 2 for _ in gens]
    ks[3], ks[5] = 0, 1
    assert FM.host_msm_windowed(spec, ks, gens) == C.host_msm(spec, ks, gens)
    assert FM.host_msm_windowed(spec, [0, 0], gens[:2]) is None
    small = [k & 0xFFFFFFFFFF for k in ks]
    assert FM.host_msm_windowed(spec, small, gens) == \
        C.host_msm(spec, small, gens)


def test_tool_runs_on_the_cpu_at_a_small_size():
    spec = C.PALLAS
    gens = C.derive_generators(spec, b"test-field-mul", 40)
    g = np.zeros((len(gens), 2, L), np.int32)
    for i, (x, y) in enumerate(gens):
        g[i, 0] = F.int_to_limbs(spec.base.to_mont_int(x))
        g[i, 1] = F.int_to_limbs(spec.base.to_mont_int(y))
    ck = CommitmentKey(spec, len(gens), g, b"", torch.device("cpu"))
    lines = []
    res = FM.run("cpu", np.random.default_rng(0), ns=(24, 40), reps=1, ck=ck,
                 msm_shapes={"wide": (40, 256), "narrow": (33, 40)},
                 out=lines.append)
    assert FM.all_ok(res)
    assert set(res) == {"N=24", "N=40", "msm"}
    names = set(res["N=24"])
    assert {"mont_mul_lm", "mont_mul_em", "mont_mul_words", "conv_mma",
            "full mont_mul"} <= names
    assert {f"stage {s}" for s in PF.STAGES} <= names
    assert set(PF.PARTS) <= names
    assert all(r["bound_ms"] is None for r in res["N=24"].values())
    assert res["msm"]["wide"]["ok"] and res["msm"]["narrow"]["ok"]
    assert any("mma conv match: True" in ln for ln in lines)
    assert len(lines) == 2 * len(res["N=24"]) + 3


def test_bound_is_bytes_for_the_digit_format():
    rate = 132 * 64 * 1980e6
    ms, by = FM.bound(131072, FM.MULS["mont_mul"], FM.DIGIT_BYTES, rate)
    assert by == "bytes" and abs(ms - 0.0150) < 1e-4
    ms, by = FM.bound(131072, FM.MULS["mont_mul"], FM.WORD_BYTES, rate)
    assert by == "bytes" and abs(ms - 0.0038) < 1e-4
    assert FM.bound(8, 1 << 20, 1, rate)[1] == "operations"
    assert FM.bound(8, 1, 1, None) == (None, "")
