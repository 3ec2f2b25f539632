"""The port's standalone verification key (nova/vk.py): the vk it writes is
byte-equal to the reference's (toy circuit and the full blake3-chunk
circuit), a vk written by the reference rebuilds an IVC that verifies the
reference's toy proof, every tampered vk is rejected with the reference's
message, and the depth-13 circuit's pp digest equals the reference's."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotproofs_tpu.circuits.dsl import compile_circuit
from hotproofs_tpu_torch.models import chunk_prover as CP
from hotproofs_tpu_torch.nova import vk as V
from hotproofs_tpu_torch.nova.ivc import IVC, IVCProof
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.nova.r1cs import ShapeDevice
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import poseidon as PS
from torch_toy_chain import P, REF_PROOF, toy_step
from torch_toy_chain import toy_gens as _toy_gens

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy_vks(tmp_path_factory):
    """(port IVC, path of the port's vk, path of the reference's vk)."""
    from hotproofs_tpu.nova import vk as RV
    from hotproofs_tpu.nova.ivc import IVC as RIVC
    from hotproofs_tpu.nova.pedersen import CommitmentKey as RCK
    from hotproofs_tpu.nova.r1cs import ShapeDevice as RShape
    from hotproofs_tpu.ops import curve as RC

    r1cs, _ = compile_circuit(toy_step, P)
    shape = ShapeDevice.from_dsl(r1cs)
    n = max(shape.n_wit, shape.n_cons)
    g = _toy_gens(n)
    ivc = IVC(shape, C.PALLAS, CommitmentKey(C.PALLAS, n, g, b"toy"), None)
    one = np.broadcast_to(RC.PALLAS.base.one_mont_limbs, (n, 32))
    ref_ck = RCK(RC.PALLAS, n, (jnp.asarray(g[:, 0]), jnp.asarray(g[:, 1]),
                                jnp.asarray(one)), g, b"toy")
    ref = RIVC(RShape.from_dsl(r1cs), RC.PALLAS, ref_ck, None)
    d = tmp_path_factory.mktemp("vk")
    ours, theirs = str(d / "port.json"), str(d / "ref.json")
    V.export_vk(ivc, ours, statement="toy", io_arity=1)
    RV.export_vk(ref, theirs, statement="toy", io_arity=1)
    return ivc, ours, theirs


def test_toy_vk_byte_equal_to_reference(toy_vks):
    _, ours, theirs = toy_vks
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_vk_of_the_reference_verifies_the_reference_proof(toy_vks):
    ivc, _, theirs = toy_vks
    got = V.ivc_from_vk(theirs, device="cpu")
    assert got.pp_digest == ivc.pp_digest
    assert got.shape.device == torch.device("cpu")
    with open(REF_PROOF) as f:
        proof = IVCProof.from_dict(json.load(f))
    assert got.verify(proof, io_arity=1) == proof.z_final(1)


def _matrix_value(d):
    d["B"]["vals"][0] = (d["B"]["vals"][0] + 1) % P
    return "vk pp digest mismatch"


def _pp_digest(d):
    d["pp_digest"] = (d["pp_digest"] + 1) % P
    return "vk pp digest mismatch"


def _wide_sponge(d):
    d["poseidon"]["t"] = 17
    return r"vk poseidon t=17 out of range \[2,16\]"


def _few_rounds(d):
    t = d["poseidon"]["t"]
    d["poseidon"]["r_partial"] = PS.neptune_round_numbers(t, 255)[1] - 1
    return "below the security lower bound"


@pytest.mark.parametrize("tamper", [_matrix_value, _pp_digest, _wide_sponge,
                                    _few_rounds],
                         ids=["matrix-value", "pp-digest", "t17",
                              "rounds"])
def test_tampered_vk_is_rejected(toy_vks, tmp_path, tamper):
    from hotproofs_tpu.nova import vk as RV

    _, _, theirs = toy_vks
    with open(theirs) as f:
        d = json.load(f)
    msg = tamper(d)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(d))
    with pytest.raises(AssertionError, match=msg):
        V.ivc_from_vk(str(bad), device="cpu")
    with pytest.raises(AssertionError, match=msg):    # the same refusal
        RV.ivc_from_vk(str(bad))


def _vk_with(path, rows=(0,), cols=(0,), vals=(1,)) -> str:
    """A one-constraint vk whose matrix A is given."""
    d = {"format": "hotproofs_tpu", "version": 2,
         "kind": "verification_key", "curve": "pallas",
         "field": C.PALLAS.scalar.name, "label": "x", "ck_label": "x",
         "ck_n": 1, "n_cons": 1, "n_vars": 3, "n_io": 2,
         "A": {"rows": list(rows), "cols": list(cols), "vals": list(vals)},
         "B": {"rows": [], "cols": [], "vals": []},
         "C": {"rows": [], "cols": [], "vals": []},
         "poseidon": {"t": 3, "r_full": 8, "r_partial": 56},
         "pp_digest": 0, "statement": "x", "io_arity": 1}
    path.write_text(json.dumps(d))
    return str(path)


@pytest.mark.parametrize("matrix,msg", [
    ({"rows": [1]}, "vk row range"), ({"cols": [3]}, "vk col range"),
    ({"vals": [1, 2]}, "vk matrix ragged")], ids=["row", "col", "ragged"])
def test_vk_matrix_checks(tmp_path, matrix, msg):
    with pytest.raises(AssertionError, match=msg):
        V.ivc_from_vk(_vk_with(tmp_path / "vk.json", **matrix),
                      device="cpu")


def test_blake3_chunk_vk_byte_equal_through_the_cli(tmp_path):
    """`export-vk --device cpu` writes the reference's vk of the full
    circuit byte for byte, and the vk rebuilds the prover's pp digest."""
    from hotproofs_tpu.models import chunk_prover as RCP
    from hotproofs_tpu.nova import vk as RV

    ours, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    CP.main(["export-vk", "--out", str(ours), "--device", "cpu"])
    ref, _, _ = RCP._build_stack()
    RV.export_vk(ref, str(theirs), statement="blake3-chunk", io_arity=15)
    assert ours.read_bytes() == theirs.read_bytes()
    ivc = V.ivc_from_vk(str(ours), device="cpu")
    assert ivc.pp_digest == ref.pp_digest
    assert (ivc.shape.n_cons, ivc.shape.n_vars, ivc.ck.n) == \
        (16162, 15953, 16384)


def test_depth13_pp_digest_matches_reference():
    from hotproofs_tpu.models import chunk_prover as RCP

    ivc, _, _ = CP._build_stack("pallas", 13, "cpu")
    ref, _, _ = RCP._build_stack(depth_bits=13)
    assert ivc.label == ref.label == b"blake3-chunk-d13"
    assert ivc.ck.n == ref.ck.n == 16384
    assert (ivc.shape.n_cons, ivc.shape.n_vars) == \
        (ref.shape.n_cons, ref.shape.n_vars)
    assert list(ivc.big_wit_idx) == list(ref.big_wit_idx)
    assert ivc.pp_digest == ref.pp_digest
    assert ivc.pp_digest != CP._build_stack("pallas", 8, "cpu")[0].pp_digest


def test_cli_refuses_verify_with_a_vk_of_another_statement(toy_vks,
                                                           tmp_path):
    """verify --vk rebuilds the toy IVC from its vk, then holds the chunk
    statement against a toy proof and refuses it."""
    _, ours, _ = toy_vks
    with open(REF_PROOF) as f:
        ivc_proof = IVCProof.from_dict(json.load(f))
    path = tmp_path / "chunk.json"
    CP.ChunkProof(ivc_proof, 0, 1, 1, 1).save(str(path))
    with pytest.raises(AssertionError, match="z0 mismatch"):
        CP.main(["verify", "--proof", str(path), "--vk", ours,
                 "--device", "cpu"])
