"""The bucket-design path's plain versions against the reference: the
signed recode against the TPU experiment's own signed_recode, the t-split
and signed-digit MSMs (bucket -> merge -> wsum) against the host oracle
host_msm as affine points, and the pure add chain against host sums of
each lane's bases."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotproofs_tpu.ops import curve as RC
from hotproofs_tpu.ops import msm as RM
from hotproofs_tpu.ops import msm_pallas as RMP
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import msm_pallas as MP
from hotproofs_tpu_torch.tools import msm_designs as D
from hotproofs_tpu_torch.utils import bridge

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SPEC = C.PALLAS


def _exp_signed_msm():
    """tools/exp_signed_msm.py, imported from its path (JAX on the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "exp_signed_msm", REPO / "tools" / "exp_signed_msm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gens(m, seed):
    rng = np.random.default_rng(seed)
    return [C.host_scalar_mul(SPEC, 1 + int.from_bytes(rng.bytes(31),
                                                       "little"), SPEC.gen)
            for _ in range(m)]


def _scalars(m, bits, seed):
    """Two jobs: random scalars < 2^bits, with a zero scalar and (at 40
    bits) a top nibble of 15 in job 0, and an all-zero job 1."""
    rng = np.random.default_rng(seed)
    ks = [[int.from_bytes(rng.bytes(32), "little") % (1 << bits)
           % SPEC.scalar.p for _ in range(m)] for _ in range(2)]
    ks[0][0] = 0
    if bits == 40 and m > 1:
        ks[0][1] |= 0xF << 36
    ks[1] = [0] * m
    return ks


def _scaled(gens, bits):
    """The reference's host-exact pre-scaled affine bases, W4 windows."""
    xa, ya = RMP.scaled_affine_host(RC.PALLAS, gens, RM.n_windows4(bits))
    return bridge.scaled_bases(xa, ya)


def _sc(ks):
    return torch.stack([torch.from_numpy(SPEC.scalar.batch_to_limbs(k))
                        for k in ks])


def _affine(s):
    d = F.words_to_digits(s)
    return C.pt_to_affine_host(SPEC, (d[:, 0], d[:, 1], d[:, 2]))


@pytest.mark.parametrize("bits", [40, 256])
@pytest.mark.parametrize("m", [20, 300])
def test_signed_digits_tm_equals_signed_recode(m, bits):
    ref = _exp_signed_msm()
    ks = _scalars(m, bits, seed=m * bits)
    sc = _sc(ks)
    b, lpw, w4, _ = MP.plan(m, MP.signed_bits(bits))
    got = MP.signed_digits_tm(sc, m, b, lpw, w4)
    want = torch.stack([torch.from_numpy(np.asarray(ref.signed_recode(
        RM._digits4(jnp.asarray(s.numpy()), w4))).astype(np.int64))
        for s in sc])                                    # (J, W4, m)
    assert torch.equal(got, MP._lanes_tm(want, m, b, lpw, w4))
    mag, neg = got & 15, got >> 4
    assert int(mag.max()) <= 8 and int(neg.max()) <= 1


def test_signed_digits_tm_needs_the_extra_window():
    sc = _sc([[0xF << 36]] * 1)
    b, lpw, w4, _ = MP.plan(1, 40)
    with pytest.raises(ValueError):
        MP.signed_digits_tm(sc, 1, b, lpw, w4)
    b, lpw, w4, _ = MP.plan(1, MP.signed_bits(40))
    assert w4 == MP.n_windows4(44)
    d = MP.signed_digits_tm(sc, 1, b, lpw, w4)[0, 0, :]   # lane w, step 0
    val = sum((16 ** w) * (-1 if int(e) >> 4 else 1) * (int(e) & 15)
              for w, e in enumerate(d[::lpw]))
    assert val == 0xF << 36


@pytest.mark.parametrize("bits", [40, 256])
@pytest.mark.parametrize("m", [20, 300])
def test_tsplit_and_signed_msm_vs_host_msm(m, bits):
    gens = _gens(m, seed=m)
    ks = _scalars(m, bits, seed=m + bits)
    want = [RC.host_msm(RC.PALLAS, k, gens) for k in ks]
    assert want[1] is None
    sc = _sc(ks)

    sbits = MP.signed_bits(bits)
    scaled = _scaled(gens, sbits)            # enough windows for both

    b, lpw, w4, _ = MP.plan(m, bits)
    bases = MP.bases_tm(*scaled, m, bits)
    d = MP.digits_tm(sc, m, b, lpw, w4)
    for H in (2, 4):
        bk = MP.msm_bucket_tsplit(SPEC, d, bases, H)
        assert _affine(MP.msm_wsum(SPEC, MP.msm_merge(SPEC, bk))) == want, H

    b, lpw, w4, _ = MP.plan(m, sbits)
    sd = MP.signed_digits_tm(sc, m, b, lpw, w4)
    bk = MP.msm_bucket_signed(SPEC, sd, MP.bases_tm(*scaled, m, sbits))
    assert bk.shape[1] == MP.NSIGNED
    assert _affine(MP.msm_wsum(SPEC, MP.msm_merge(SPEC, bk))) == want


@pytest.mark.parametrize("bits", [40, 256])
def test_signed_slots_wsum_vs_serial_suffix_sum(bits):
    """msm_wsum's scan-and-tree order at the signed digits' S = 8 (G = 8
    lanes, 6 dependent adds) over the merged signed buckets == the
    reference's running suffix sum over the same 8 slots on the host
    oracle, as affine points; the all-zero job's slots and sum are the
    identity."""
    m = 20
    gens = _gens(m, seed=bits + 3)
    ks = _scalars(m, bits, seed=bits + 4)
    sbits = MP.signed_bits(bits)
    b, lpw, w4, _ = MP.plan(m, sbits)
    sd = MP.signed_digits_tm(_sc(ks), m, b, lpw, w4)
    red = MP.msm_merge(SPEC, MP.msm_bucket_signed(
        SPEC, sd, MP.bases_tm(*_scaled(gens, sbits), m, sbits)))
    J, S = red.shape[:2]
    assert (S, MP.wsum_group(S), MP.wsum_depth(S)) == (MP.NSIGNED, 8, 6)
    slots = C.pt_to_affine_host(SPEC, tuple(
        F.words_to_digits(red[:, :, c]).reshape(J * S, 32)
        for c in range(3)))
    want = []
    for j in range(J):
        t = s = None
        for p in reversed(slots[j * S:(j + 1) * S]):
            t = RC.host_add(RC.PALLAS, t, p)
            s = RC.host_add(RC.PALLAS, s, t)
        want.append(s)
    assert _affine(MP.msm_wsum(SPEC, red)) == want
    assert want == [RC.host_msm(RC.PALLAS, k, gens) for k in ks]
    assert slots[S:2 * S] == [None] * S and want[1] is None


@pytest.mark.parametrize("m,bits", [(24, 256), (320, 40)])
def test_msm_chain_equals_host_lane_sums(m, bits):
    """Lane w * lpw + c sums 16^w G_i over i in [c B, (c + 1) B); the
    S = 1 merge and wsum add every lane."""
    gens = _gens(m, seed=m + 1)
    b, lpw, w4, n_lanes = MP.plan(m, bits)
    assert m % b == 0
    ch = MP.msm_chain(SPEC, MP.bases_tm(*_scaled(gens, bits), m, bits), 2)
    assert ch.shape == (2, 3, 8, n_lanes)
    assert torch.equal(ch[0], ch[1])
    lanes = _affine(ch[0].permute(2, 0, 1).contiguous())
    scaled = [[RC.host_scalar_mul(RC.PALLAS, 16 ** w, g) for g in gens]
              for w in range(w4)]
    want = []
    for w in range(w4):
        for c in range(lpw):
            acc = None
            for g in scaled[w][c * b:(c + 1) * b]:
                acc = RC.host_add(RC.PALLAS, acc, g)
            want.append(acc)
    assert lanes == want
    total = MP.msm_wsum(SPEC, MP.msm_merge(SPEC, ch[:, None].contiguous()))
    k = sum(16 ** w for w in range(w4)) % SPEC.scalar.p
    assert _affine(total) == [RC.host_msm(RC.PALLAS, [k] * m, gens)] * 2


def test_designs_tool_checks_every_design():
    """tools/msm_designs.py on the CPU at a tiny shape: every design's MSM
    agrees with msm_many (the chain with its plain version), a stages line,
    a digit statistics line, a line of msm_many at each B and one report
    line per design, and the host per-fold costs are timed."""
    rng = np.random.default_rng(5)
    key = CommitmentKey.create(SPEC, b"", 64)
    res = D.measure(D.prepare(key, D.random_scalars(rng, 2, 40, 40, "cpu"),
                              40), 1)
    assert list(res["designs"]) == list(D.DESIGNS)
    assert all(d["ok"] for d in res["designs"].values()), res["designs"]
    assert len(D.report("cpu", res)) == 3 + len(D.DESIGNS)
    assert set(D.host_fold_costs(rng, 2)) == {"host_transcript_fold_ms",
                                              "host_fold_instance_ms"}


def test_digit_stats_equal_a_direct_count():
    """digit_stats on a small seeded sparse batch == counts made lane by
    lane and warp by warp."""
    rng = np.random.default_rng(17)
    J, m, bits = 3, 300, 40
    raw = rng.integers(0, 256, size=(J, m, 32), dtype=np.int64)
    raw[..., (bits + 7) // 8:] = 0
    raw[rng.random((J, m, 32)) < 0.9] = 0
    raw[1] = 0
    sc = torch.from_numpy(raw.astype(np.int32))
    b, lpw, w4, L = MP.plan(m, bits)
    d = MP.digits_tm(sc, m, b, lpw, w4)
    st = D.digit_stats(sc, d, bits)
    dn = d.numpy()
    nib = [[[(int(raw[j, i, w // 2]) >> (4 * (w % 2))) & 15 for i in range(m)]
            for w in range(w4)] for j in range(J)]
    for w in range(w4):
        want = sum(nib[j][w][i] != 0 for j in range(J) for i in range(m))
        assert st["nonzero_per_window"][w] == pytest.approx(want / (J * m))
    touched = sum(len(set(dn[j, :, lane].tolist()) - {0})
                  for j in range(J) for lane in range(L))
    assert st["touched"] == pytest.approx(touched / (J * L * MP.NBUCKET))
    flat = [(j, lane) for j in range(J) for lane in range(L)]
    warps = [flat[i:i + 32] for i in range(0, len(flat), 32)]
    lockstep = [sum(any(dn[j, t, lane] for j, lane in wp) for t in range(b))
                for wp in warps]
    assert st["adds_lockstep"] == pytest.approx(np.mean(lockstep))
    walk = [max(int((dn[j, :, lane] != 0).sum())
                for lane in range(lo, min(lo + 32, L)))
            for j in range(J) for lo in range(0, L, 32)]
    assert st["adds_walk"] == pytest.approx(np.mean(walk))
    assert st["adds_walk"] <= st["adds_lockstep"]


def test_designs_tool_times_each_plan_b_at_256_bits():
    """At 256 bits too the tool runs msm_many at every B of PLAN_BS and
    holds each against plan's; its report has the digit and B lines."""
    rng = np.random.default_rng(6)
    key = CommitmentKey.create(SPEC, b"", 64)
    res = D.measure(D.prepare(key, D.random_scalars(rng, 1, 20, 256, "cpu"),
                              256), 1)
    assert sorted(res["plan_b"]) == sorted(D.PLAN_BS)
    assert D.all_ok({**{t: {"designs": {}, "plan_b": {}} for t in D.SHAPES},
                     "comm_T J=1": res})
    assert 0 < res["digit_stats"]["touched"] <= 1
    lines = D.report("cpu", res)
    assert len(lines) == 3 + len(D.DESIGNS)
    assert "sorted walk" in lines[1] and "B=16" in lines[2]
