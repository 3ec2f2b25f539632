"""The port's IVC on the toy circuit of tests/test_ivc_toy.py: same pp
digest as the reference, a proof byte-identical to the reference's
(tests/data/torch_toy_proof_ref.json, made by the JAX package's
IVC.prove), acceptance of the reference proof, rejection of tampered
proofs, and lockstep == separate chains."""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotproofs_tpu.circuits.dsl import eval_witness
from hotproofs_tpu_torch.nova.ivc import IVC, IVCProof
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.utils import bridge, telemetry
from torch_toy_chain import CONST, P, toy_ivc, toy_step
from torch_toy_chain import chain as _chain
from torch_toy_chain import ref_dict as _ref_dict
from torch_toy_chain import toy_gens as _toy_gens

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy():
    return toy_ivc()


def test_pp_digest_matches_reference(toy):
    from hotproofs_tpu.nova.ivc import IVC as RIVC
    from hotproofs_tpu.nova.pedersen import CommitmentKey as RCK
    from hotproofs_tpu.nova.r1cs import ShapeDevice as RShape
    from hotproofs_tpu.ops import curve as RC

    ivc, r1cs, _ = toy
    ref_shape = RShape.from_dsl(r1cs)
    n = max(ref_shape.n_wit, ref_shape.n_cons)
    g = _toy_gens(n)
    one = np.broadcast_to(RC.PALLAS.base.one_mont_limbs, (n, 32))
    ref_ck = RCK(RC.PALLAS, n, (jnp.asarray(g[:, 0]), jnp.asarray(g[:, 1]),
                                jnp.asarray(one)), g, b"toy")
    ref = RIVC(ref_shape, RC.PALLAS, ref_ck, None)
    assert ivc.pp_digest == ref.pp_digest == _ref_dict()["pp_digest"]
    assert np.array_equal(bridge.gens_affine(ref_ck.gens_affine).numpy(),
                          ivc.ck.gens_affine)
    # The bridge carries the reference's key and shape over unchanged.
    port = IVC(bridge.shape(ref_shape), C.PALLAS,
               bridge.commitment_key(ref_ck), None)
    assert port.pp_digest == ref.pp_digest


def test_prove_batch_byte_equal_to_reference(toy):
    ivc, _, layout = toy
    canon, X, z = _chain(layout, 3, 5)
    folds = lambda: telemetry.metrics.snapshot().get("ivc/folds", 0)
    before = folds()
    proof = ivc.prove_batch([3], canon, X)
    assert folds() == before + 5
    assert json.dumps(proof.to_dict()) == json.dumps(_ref_dict())
    assert ivc.verify(proof, io_arity=1) == [z]


def test_verify_accepts_reference_and_rejects_tampering(toy):
    ivc, _, _ = toy
    ref = _ref_dict()
    proof = bridge.ivc_proof(ref)
    z_final = proof.steps[-1].X[0]
    assert ivc.verify(proof, io_arity=1) == [z_final]

    bad_io = IVCProof.from_dict(copy.deepcopy(ref))
    bad_io.steps[-1].X[0] = (bad_io.steps[-1].X[0] + 1) % P
    with pytest.raises(AssertionError):
        ivc.verify(bad_io, io_arity=1)

    bad_w = IVCProof.from_dict(copy.deepcopy(ref))
    bad_w.final_W[0] = (bad_w.final_W[0] + 1) % P
    with pytest.raises(AssertionError, match="final W"):
        ivc.verify(bad_w, io_arity=1)

    bad_t = IVCProof.from_dict(copy.deepcopy(ref))
    bad_t.comm_Ts[1] = bad_t.comm_Ts[2]
    with pytest.raises(AssertionError):
        ivc.verify(bad_t, io_arity=1)


def test_rejects_broken_chain(toy):
    ivc, _, layout = toy
    c1, X1, _ = _chain(layout, 3, 2)
    c2, X2, _ = _chain(layout, 5, 1)           # unrelated step
    proof = ivc.prove_batch([3], np.concatenate([c1, c2]), X1 + X2)
    with pytest.raises(AssertionError, match="chaining"):
        ivc.verify(proof, io_arity=1)


def test_prove_lockstep_equals_separate_chains(toy):
    ivc, _, layout = toy
    ca, Xa, _ = _chain(layout, 4, 3)
    cb, Xb, zb = _chain(layout, 9, 2)          # shorter chain
    both = ivc.prove_lockstep([([4], ca, Xa), ([9], cb, Xb)], chunk_steps=2)
    one_a = ivc.prove_batch([4], ca, Xa)
    one_b = ivc.prove_batch([9], cb, Xb)
    assert both[0].to_dict() == one_a.to_dict()
    assert both[1].to_dict() == one_b.to_dict()
    assert ivc.verify(both[1], io_arity=1) == [zb]


@pytest.mark.slow  # the reference's XLA prove/verify compile for minutes
def test_reference_proof_regenerates_and_cross_verifies(toy):
    from hotproofs_tpu.nova.ivc import IVC as RIVC
    from hotproofs_tpu.nova.ivc import IVCProof as RProof
    from hotproofs_tpu.nova.pedersen import CommitmentKey as RCK
    from hotproofs_tpu.nova.r1cs import ShapeDevice as RShape
    from hotproofs_tpu.ops import curve as RC

    ivc, r1cs, layout = toy
    ref_shape = RShape.from_dsl(r1cs)
    ref = RIVC(ref_shape, RC.PALLAS,
               RCK.create(RC.PALLAS, b"toy", max(ref_shape.n_wit,
                                                 ref_shape.n_cons)), None)
    z, wits = 3, []
    for _ in range(5):
        wits.append(eval_witness(toy_step, layout, {"z_in": [z]}))
        z = (pow(z, 3, P) + CONST) % P
    live = ref.prove([3], wits).to_dict()
    assert json.dumps(live) == json.dumps(_ref_dict())
    canon, X, _ = _chain(layout, 3, 5)
    port = ivc.prove_batch([3], canon, X)
    assert ref.verify(RProof.from_dict(port.to_dict()), io_arity=1) == [z]
