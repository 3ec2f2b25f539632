"""The port's segment-parallel proving (parallel/segments.py) on the toy
circuit of tests/torch_toy_chain.py: the reference's split plan, segment
proofs byte-equal to standalone prove_batch runs on both paths, the
verifier's rejections, resume from checkpoints, retries, verify_each, and
files that the reference reads and writes back to the same bytes."""

import json
import os

import numpy as np
import pytest
import torch

from hotproofs_tpu.circuits.dsl import compile_circuit
from hotproofs_tpu_torch.models import chunk_prover as CP
from hotproofs_tpu_torch.nova.ivc import IVC, IVCProof
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.nova.r1cs import ShapeDevice
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.parallel import segments as S
from hotproofs_tpu_torch.utils import telemetry
from torch_toy_chain import CONST, P, toy_step
from torch_toy_chain import chain as _chain
from torch_toy_chain import toy_gens as _toy_gens

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

N_STEPS, K = 8, 3
BOUNDS = [(0, 3), (3, 6), (6, 8)]


@pytest.fixture(scope="module")
def toy():
    """(ivc, zs, canon, X, standalone proofs of BOUNDS' ranges)."""
    r1cs, layout = compile_circuit(toy_step, P)
    shape = ShapeDevice.from_dsl(r1cs)
    n = max(shape.n_wit, shape.n_cons)
    ivc = IVC(shape, C.PALLAS, CommitmentKey(C.PALLAS, n, _toy_gens(n),
                                             b"toy"), None)
    canon, X, _ = _chain(layout, 3, N_STEPS)
    zs = [[3]]
    for _ in range(N_STEPS):
        zs.append([(pow(zs[-1][0], 3, P) + CONST) % P])
    alone = [ivc.prove_batch(zs[a], canon[a:b], X[a:b]) for a, b in BOUNDS]
    return ivc, zs, canon, X, alone


@pytest.fixture(scope="module")
def seg(toy):
    ivc, zs, canon, X, _ = toy
    return S.prove_segments(ivc, zs, canon, X, K, lockstep=True)


def _bytes(p) -> str:
    return json.dumps(p.to_dict())


def _counts():
    c = telemetry.metrics.snapshot()
    return {k: c.get(f"segments/{k}", 0)
            for k in ("proved", "resumed", "retried")}


def _delta(before):
    after = _counts()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 16, 100])
def test_split_plan_matches_reference(k):
    from hotproofs_tpu.parallel.segments import split_plan as R_split_plan

    for n in range(1, 40):
        plan = S.split_plan(n, k)
        assert plan == R_split_plan(n, k)
        assert plan[0][0] == 0 and plan[-1][1] == n and len(plan) == min(k, n)
    assert S.split_plan(N_STEPS, K) == BOUNDS


@pytest.mark.parametrize("lockstep", [True, False], ids=["lockstep", "pool"])
def test_segments_equal_standalone_proofs(toy, lockstep, monkeypatch):
    ivc, zs, canon, X, alone = toy
    uploaded = []
    to_device = ivc._to_device
    monkeypatch.setattr(ivc, "_to_device",
                        lambda a: uploaded.append(a.shape[0]) or to_device(a))
    waves = []
    kw = {"on_wave": lambda ks, s: waves.append((ks, s))} if lockstep \
        else {"max_workers": 2}
    before = _counts()
    sp = S.prove_segments(ivc, zs, canon, X, K, lockstep=lockstep, **kw)
    assert _delta(before) == {"proved": K, "resumed": 0, "retried": 0}
    assert [_bytes(p) for p in sp.segments] == [_bytes(p) for p in alone]
    assert sp.num_steps == N_STEPS and sp.z0 == [3]
    # Numpy witnesses go to the device one chunk of steps at a time.
    assert max(uploaded) <= 3
    assert S.verify_segments(ivc, sp, io_arity=1) == zs[-1]
    if lockstep:   # one wave of every segment, timed by its span
        assert [ks for ks, _ in waves] == [list(range(K))]
        assert waves[0][1] > 0
    else:
        with pytest.raises(AssertionError, match="requires lockstep"):
            S.prove_segments(ivc, zs, canon, X, K, on_wave=print)


def _swapped(sp):
    sp.segments[1], sp.segments[2] = sp.segments[2], sp.segments[1]
    return "does not chain"


def _missing(sp):
    sp.segments[1] = None
    return "segment 1 missing"


def _broken(sp):
    sp.segments[2].z0[0] = (sp.segments[2].z0[0] + 1) % P
    return "segment 2 does not chain from segment 1"


@pytest.mark.parametrize("tamper", [_swapped, _missing, _broken],
                         ids=["swapped", "missing", "boundary"])
def test_verify_segments_rejects(toy, seg, tamper):
    ivc = toy[0]
    bad = S.SegmentedProof.from_dict(seg.to_dict())
    msg = tamper(bad)
    with pytest.raises(AssertionError, match=msg):
        S.verify_segments(ivc, bad, io_arity=1)


def test_resume_after_one_checkpoint_is_deleted(toy, seg, tmp_path):
    ivc, zs, canon, X, _ = toy
    for k, p in enumerate(seg.segments):
        p.save(str(tmp_path / f"segment_{k:05d}.json"))
    os.remove(tmp_path / "segment_00001.json")
    before = _counts()
    again = S.prove_segments(ivc, zs, canon, X, K, lockstep=True,
                             checkpoint_dir=str(tmp_path))
    assert _delta(before) == {"proved": 1, "resumed": K - 1, "retried": 0}
    assert _bytes(again) == _bytes(seg)
    assert IVCProof.load(str(tmp_path / "segment_00001.json")).to_dict() \
        == seg.segments[1].to_dict()


def _foreign(seg):
    bad = IVCProof.from_dict(seg.segments[0].to_dict())
    bad.pp_digest += 1
    return bad


def _short(seg):
    return seg.segments[2]          # 2 steps where segment 0 has 3


@pytest.mark.parametrize("stale", [_foreign, _short],
                         ids=["foreign", "short"])
def test_foreign_or_short_checkpoint_is_proved_again(toy, seg, tmp_path,
                                                      stale):
    ivc, zs, canon, X, _ = toy
    for k, p in enumerate(seg.segments):
        p.save(str(tmp_path / f"segment_{k:05d}.json"))
    stale(seg).save(str(tmp_path / "segment_00000.json"))
    before = _counts()
    again = S.prove_segments(ivc, zs, canon, X, K,
                             checkpoint_dir=str(tmp_path))
    assert _delta(before) == {"proved": 1, "resumed": K - 1, "retried": 0}
    assert _bytes(again) == _bytes(seg)
    assert IVCProof.load(str(tmp_path / "segment_00000.json")).to_dict() \
        == seg.segments[0].to_dict()


class Killed(Exception):
    pass


def test_lockstep_killed_after_first_wave_resumes(toy, seg, tmp_path,
                                                   monkeypatch):
    ivc, zs, canon, X, _ = toy
    waves = []
    prove_lockstep = ivc.prove_lockstep

    def killed_after_one(chains, **kw):
        if waves:
            raise Killed
        waves.append(len(chains))
        return prove_lockstep(chains, **kw)

    monkeypatch.setattr(ivc, "prove_lockstep", killed_after_one)
    with pytest.raises(Killed):
        S.prove_segments(ivc, zs, canon, X, K, lockstep=True,
                         lockstep_group=2, checkpoint_dir=str(tmp_path))
    assert waves == [2]
    assert sorted(os.listdir(tmp_path)) == ["segment_00000.json",
                                            "segment_00001.json"]
    monkeypatch.setattr(ivc, "prove_lockstep", prove_lockstep)
    before = _counts()
    again = S.prove_segments(ivc, zs, canon, X, K, lockstep=True,
                             lockstep_group=2, checkpoint_dir=str(tmp_path))
    assert _delta(before) == {"proved": 1, "resumed": 2, "retried": 0}
    assert _bytes(again) == _bytes(seg)


def test_failed_prove_is_retried(toy, seg, monkeypatch):
    ivc, zs, canon, X, _ = toy
    calls = []
    prove_batch = ivc.prove_batch

    def fails_once(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device fault")
        return prove_batch(*a, **kw)

    monkeypatch.setattr(ivc, "prove_batch", fails_once)
    before = _counts()
    got = S.prove_segments(ivc, zs, canon, X, K, retries=1, max_workers=1)
    assert _delta(before) == {"proved": K, "resumed": 0, "retried": 1}
    assert len(calls) == K + 1 and _bytes(got) == _bytes(seg)


def test_retries_run_out(toy, monkeypatch):
    ivc, zs, canon, X, _ = toy

    def always_fails(*a, **kw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(ivc, "prove_batch", always_fails)
    before = _counts()
    with pytest.raises(RuntimeError, match="segment 0 failed after 3"):
        S.prove_segments(ivc, zs, canon, X, K, retries=2)
    assert _delta(before)["retried"] == 3


def test_verify_each_catches_a_corrupted_proof(toy, seg, monkeypatch):
    ivc, zs, canon, X, _ = toy
    corrupted = []
    prove_batch = ivc.prove_batch

    def flips_a_bit_once(*a, **kw):
        p = prove_batch(*a, **kw)
        if not corrupted:
            corrupted.append(1)
            p.final_W[0] = (p.final_W[0] + 1) % P
        return p

    monkeypatch.setattr(ivc, "prove_batch", flips_a_bit_once)
    before = _counts()
    got = S.prove_segments(ivc, zs, canon, X, K, verify_each=True)
    assert _delta(before) == {"proved": K, "resumed": 0, "retried": 1}
    assert _bytes(got) == _bytes(seg)


def test_files_round_trip_through_the_reference(seg, tmp_path):
    from hotproofs_tpu.models import chunk_prover as RCP
    from hotproofs_tpu.nova.ivc import IVCProof as RProof
    from hotproofs_tpu.parallel import segments as RS

    def both_ways(port_cls, ref_cls, obj, name):
        ours, back = tmp_path / f"{name}.json", tmp_path / f"{name}.ref.json"
        obj.save(str(ours))
        ref_cls.load(str(ours)).save(str(back))
        assert back.read_bytes() == ours.read_bytes()
        again = tmp_path / f"{name}.again.json"
        port_cls.load(str(back)).save(str(again))
        assert again.read_bytes() == ours.read_bytes()

    both_ways(IVCProof, RProof, seg.segments[1], "ivc")
    both_ways(S.SegmentedProof, RS.SegmentedProof, seg, "seg")
    both_ways(CP.SegmentedChunkProof, RCP.SegmentedChunkProof,
              CP.SegmentedChunkProof(seg, 5, 16, 17, 20), "chunk")


@pytest.mark.slow  # the reference's XLA verify compiles for minutes
def test_reference_verifies_the_port_segmented_proof(toy, seg):
    from hotproofs_tpu.nova.ivc import IVC as RIVC
    from hotproofs_tpu.nova.pedersen import CommitmentKey as RCK
    from hotproofs_tpu.nova.r1cs import ShapeDevice as RShape
    from hotproofs_tpu.ops import curve as RC
    from hotproofs_tpu.parallel import segments as RS

    r1cs, _ = compile_circuit(toy_step, P)
    ref_shape = RShape.from_dsl(r1cs)
    ref = RIVC(ref_shape, RC.PALLAS,
               RCK.create(RC.PALLAS, b"toy", max(ref_shape.n_wit,
                                                 ref_shape.n_cons)), None)
    proof = RS.SegmentedProof.from_dict(seg.to_dict())
    assert RS.verify_segments(ref, proof, io_arity=1) == toy[1][-1]


def test_host_witness_chain_equals_the_device_chain():
    """The long-chain witness path (host numpy, generated in slices) gives
    the same digits as the one-slice device path, at full circuit width."""
    prover = CP.ChunkProver(device="cpu")
    data = bytes(range(256)) * 4 + bytes(range(100))   # 2 chunks
    pd = prover._hash_with_path(data, 1)
    zs, sched, canon, X = prover._device_witness_chain(pd)
    zs2, sched2, host, X2 = prover._host_witness_chain(pd, slice_steps=2)
    assert isinstance(host, np.ndarray) and host.dtype == np.int32
    assert host.shape == tuple(canon.shape) and host.shape[0] == 3
    assert np.array_equal(host, canon.numpy())
    assert (zs2, X2) == (zs, X)


def test_longchain_tool_stops_after_a_wave_and_resumes(toy, seg, tmp_path):
    """tools/longchain_deep.prove: a run stopped after its first wave
    leaves that wave's checkpoints; the rerun resumes them and proves the
    rest, giving the same bytes."""
    from types import SimpleNamespace

    from hotproofs_tpu_torch.tools import longchain_deep as LD

    ivc, zs, canon, X, _ = toy
    prover = SimpleNamespace(ivc=ivc)
    chain = {"zs": zs, "canon": canon, "X_host": X}
    first = LD.prove(prover, chain, K, 2, str(tmp_path), stop_after=1)
    assert first["proof"] is None
    assert (first["proved"], first["resumed"]) == (2, 0)
    assert [(w["segments"], w["folds"]) for w in first["waves"]] == [(2, 6)]
    second = LD.prove(prover, chain, K, 2, str(tmp_path))
    assert (second["proved"], second["resumed"]) == (1, 2)
    assert [(w["segments"], w["folds"]) for w in second["waves"]] == [(1, 2)]
    assert _bytes(second["proof"]) == _bytes(seg)


def test_longchain_tool_statement_and_card_default():
    """The deep chain's public states end at its published root at depth 0
    on the depth-13 circuit, and the tool refuses to run without a card
    unless asked for the CPU."""
    from hotproofs_tpu_torch.tools import longchain_deep as LD

    prover = CP.ChunkProver(depth_bits=LD.DEPTH_BITS, device="cpu")
    assert prover.ivc.label == b"blake3-chunk-d13"
    chain = LD.deep_chain(prover, 18)
    z = chain["zs"][-1]
    root = chain["pd"].root_hash
    assert z[2:10] == [int.from_bytes(root[4 * i: 4 * i + 4], "little")
                       for i in range(8)]
    assert z[11] == 0 and chain["canon"].shape[0] == 18
    assert isinstance(chain["canon"], np.ndarray)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            LD.main(["--steps", "32"])


def test_launch_counts_stay_exact_under_threads():
    """The thread-pool path launches kernels from several threads: no
    increment of a kernel's launch count may be lost."""
    import sys
    import threading

    from hotproofs_tpu_torch.ops import cuda_lib

    n_threads, n_each = 32, 2000
    before = cuda_lib.launches["msm_wsum"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [cuda_lib.count_launch("msm_wsum")
                            for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert cuda_lib.launches["msm_wsum"] == before + n_threads * n_each
    cuda_lib.launches["msm_wsum"] = before
