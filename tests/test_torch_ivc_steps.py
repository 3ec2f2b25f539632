"""The port's per-step prover and prover checkpoints on the toy chain of
tests/torch_toy_chain.py: IVC.prove byte-equal to the reference's proof
(tests/data/torch_toy_proof_ref.json, made by the JAX package's
IVC.prove) and to prove_batch; a chain cut at every step, saved, loaded
into a fresh IVC and resumed gives the unbroken chain's bytes; the port's
checkpoint byte-equal to the reference's (tests/data/
torch_toy_checkpoint_ref.json), each package loading the other's;
refusals with the reference's messages; and ChunkProver.prove(fast=False)
equal to fast=True at full circuit width (commitments by a host oracle:
the real key's preparation takes minutes on the CPU)."""

import copy
import json

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.nova.ivc import IVCProof, ProverCheckpoint
from torch_toy_chain import (CKPT_EVERY, CKPT_STEPS, CKPT_Z0, P,
                             REF_CHECKPOINT, chain, ref_dict, toy_ivc,
                             witnesses)

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _bytes(proof) -> str:
    return json.dumps(proof.to_dict())


@pytest.fixture(scope="module")
def toy():
    return toy_ivc()


@pytest.fixture(scope="module")
def ref_chain(toy):
    """The reference fixtures' chain: canon, X, z_final, its witnesses."""
    _, _, layout = toy
    canon, X, z = chain(layout, CKPT_Z0, CKPT_STEPS)
    wits, _ = witnesses(layout, CKPT_Z0, CKPT_STEPS)
    return canon, X, z, wits


def test_prove_per_step_byte_equal_to_reference_and_batch(toy, ref_chain):
    ivc, _, _ = toy
    canon, X, z, wits = ref_chain
    proof = ivc.prove([CKPT_Z0], iter(wits))
    assert _bytes(proof) == json.dumps(ref_dict())
    assert _bytes(proof) == _bytes(ivc.prove_batch([CKPT_Z0], canon, X))
    assert ivc.verify(proof, io_arity=1) == [z]
    assert len(ivc.timings) == CKPT_STEPS
    assert set(ivc.timings[0]) == {"witness", "device", "commit", "host"}


def test_prove_per_step_refused_when_changed_or_broken(toy, ref_chain):
    ivc, _, layout = toy
    _, _, _, wits = ref_chain
    proof = ivc.prove([CKPT_Z0], wits[:3])
    bad = IVCProof.from_dict(copy.deepcopy(proof.to_dict()))
    bad.steps[1].X[0] = (bad.steps[1].X[0] + 1) % P
    with pytest.raises(AssertionError):
        ivc.verify(bad, io_arity=1)
    other, _ = witnesses(layout, 5, 1)             # an unrelated step
    broken = ivc.prove([CKPT_Z0], wits[:2] + other)
    with pytest.raises(AssertionError, match="chaining"):
        ivc.verify(broken, io_arity=1)


@pytest.mark.slow  # the reference's XLA verify compiles for minutes
def test_reference_verifies_per_step_proof(toy, ref_chain):
    from hotproofs_tpu.nova.ivc import IVC as RIVC
    from hotproofs_tpu.nova.ivc import IVCProof as RProof
    from hotproofs_tpu.nova.pedersen import CommitmentKey as RCK
    from hotproofs_tpu.nova.r1cs import ShapeDevice as RShape
    from hotproofs_tpu.ops import curve as RC

    ivc, r1cs, _ = toy
    _, _, z, wits = ref_chain
    shape = RShape.from_dsl(r1cs)
    ref = RIVC(shape, RC.PALLAS, RCK.create(
        RC.PALLAS, b"toy", max(shape.n_wit, shape.n_cons)), None)
    proof = ivc.prove([CKPT_Z0], wits)
    assert ref.verify(RProof.from_dict(proof.to_dict()), io_arity=1) == [z]


@pytest.mark.parametrize("every,chunk_steps",
                         [(1, 16), (2, 16), (3, 16), (4, 16), (2, 2),
                          (3, 3)])
def test_checkpoint_resume_gives_the_unbroken_chain(toy, ref_chain, tmp_path,
                                                    every, chunk_steps):
    """Saved after every `every` folds (the file keeps the last save, at a
    chunk boundary where every == chunk_steps), loaded into a fresh IVC
    and resumed: the bytes of the unbroken chain."""
    ivc, _, _ = toy
    canon, X, z, _ = ref_chain
    path = str(tmp_path / "ckpt.json")
    whole = ivc.prove_batch([CKPT_Z0], canon, X, chunk_steps=chunk_steps,
                            checkpoint_path=path, checkpoint_every=every)
    assert _bytes(whole) == json.dumps(ref_dict())
    cp = ProverCheckpoint.load(path)
    assert cp.next_step == (CKPT_STEPS - 1) // every * every
    fresh, _, _ = toy_ivc()
    resumed = fresh.prove_batch([CKPT_Z0], canon, X, chunk_steps=chunk_steps,
                                resume=cp)
    assert _bytes(resumed) == _bytes(whole)
    assert fresh.verify(resumed, io_arity=1) == [z]


def test_checkpoint_byte_equal_to_reference(toy, ref_chain, tmp_path):
    """The port's checkpoint of the reference's run (after fold 4) has the
    fixture's bytes, and resuming from the fixture gives the reference's
    proof."""
    ivc, _, _ = toy
    canon, X, _, _ = ref_chain
    path = str(tmp_path / "ckpt.json")
    ivc.prove_batch([CKPT_Z0], canon, X, checkpoint_path=path,
                    checkpoint_every=CKPT_EVERY)
    with open(path, "rb") as f, open(REF_CHECKPOINT, "rb") as g:
        assert f.read() == g.read()
    fresh, _, _ = toy_ivc()
    resumed = fresh.prove_batch([CKPT_Z0], canon, X,
                                resume=ProverCheckpoint.load(REF_CHECKPOINT))
    assert _bytes(resumed) == json.dumps(ref_dict())


def test_checkpoint_files_load_in_both_packages(toy, ref_chain, tmp_path):
    from dataclasses import asdict

    from hotproofs_tpu.nova.ivc import ProverCheckpoint as RCheckpoint

    ivc, _, _ = toy
    canon, X, _, _ = ref_chain
    path = str(tmp_path / "port.json")
    ivc.prove_batch([CKPT_Z0], canon, X, checkpoint_path=path,
                    checkpoint_every=3)
    mine = ProverCheckpoint.load(path)
    assert asdict(RCheckpoint.load(path)) == asdict(mine)
    ref = RCheckpoint.load(REF_CHECKPOINT)
    assert asdict(ProverCheckpoint.load(REF_CHECKPOINT)) == asdict(ref)
    again = str(tmp_path / "again.json")
    ref.save(again)
    with open(again, "rb") as f, open(REF_CHECKPOINT, "rb") as g:
        assert f.read() == g.read()


def test_checkpoint_refusals(toy, ref_chain):
    ivc, _, _ = toy
    canon, X, _, _ = ref_chain
    other = ProverCheckpoint.load(REF_CHECKPOINT)
    other.pp_digest = (other.pp_digest + 1) % P
    with pytest.raises(AssertionError,
                       match="checkpoint is for a different circuit/key"):
        ivc.prove_batch([CKPT_Z0], canon, X, resume=other)
    corrupt = ProverCheckpoint.load(REF_CHECKPOINT)
    corrupt.next_step += 1
    with pytest.raises(AssertionError, match="corrupt checkpoint"):
        ivc.prove_batch([CKPT_Z0], canon, X, resume=corrupt)
    short = ProverCheckpoint.load(REF_CHECKPOINT)
    short.acc_E = short.acc_E[:-1]
    with pytest.raises(AssertionError, match="corrupt checkpoint"):
        ivc.prove_batch([CKPT_Z0], canon, X, resume=short)


@pytest.mark.slow  # the reference's XLA prove_batch compiles for minutes
def test_reference_checkpoint_regenerates(tmp_path):
    from torch_toy_chain import make_reference_checkpoint

    path = str(tmp_path / "ref.json")
    assert json.dumps(make_reference_checkpoint(path)) == \
        json.dumps(ref_dict())
    with open(path, "rb") as f, open(REF_CHECKPOINT, "rb") as g:
        assert f.read() == g.read()


class OracleKey:
    """Homomorphic stand-in commitments for a full-width key on the CPU:
    commit(v) = (sum v_i k_i) G with seeded 64-bit k_i, one host scalar
    multiplication a point, the same for every path that commits."""

    def __init__(self, ck, n):
        from hotproofs_tpu_torch.ops import curve as C
        self.C, self.spec = C, ck.spec
        self.G = C.derive_generators(ck.spec, b"oracle", 1)[0]
        rng = np.random.default_rng(7)
        self.k = [int(v) for v in rng.integers(1, 1 << 62, size=n)]

    def commit_many(self, scalars, max_bits=256):
        vals = self.spec.scalar.limbs_to_ints(scalars.cpu().numpy())
        return [sum(int(v) * k for v, k in zip(row, self.k))
                for row in vals]

    def commit_many_split(self, scalars, big_idx):
        return self.commit_many(scalars)

    def affine(self, sums):
        q = self.spec.scalar.p
        return [self.C.host_scalar_mul(self.spec, s % q, self.G)
                for s in sums]


def test_chunk_prove_per_step_equals_batched(monkeypatch):
    from hotproofs_tpu_torch.models import chunk_prover as CP

    prover = CP.ChunkProver(device="cpu")
    ivc = prover.ivc
    oracle = OracleKey(ivc.ck, ivc.ck.n)
    monkeypatch.setattr(ivc, "prepare_key", lambda: None)
    for name in ("commit_many", "commit_many_split", "affine"):
        monkeypatch.setattr(ivc.ck, name, getattr(oracle, name))
    data = bytes(range(256)) * 4 + bytes(range(100))   # 2 chunks
    root, fast = prover.prove(data, 1)
    root2, slow = prover.prove(data, 1, fast=False)
    assert root2 == root
    assert fast.ivc_proof.num_steps == 3
    assert json.dumps(slow.to_dict()) == json.dumps(fast.to_dict())
    assert len(ivc.timings) == 3
    with pytest.raises(AssertionError, match="one device"):
        prover.prove(data, 1, fast=False, mesh=object())
