"""The chunk prover on the card: the verification key through the CLI,
segments, the reference's real-size proof (verified, and equal to the
port's proof of the same chunk byte for byte), and compressed proofs (the
CLI's prove --compress, the reference's chunk proof compressed, the
reference's Spartan fixtures byte-equal).

Marked `cuda`: without a CUDA device each test skips (the decision is made
inside the fixture, never at import). On a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda_chunk.py -q -m cuda
"""

import gzip
import json
import pathlib

import pytest
import torch

from hotproofs_tpu_torch.core import blake3_ref as b3
from hotproofs_tpu_torch.models import chunk_prover as CP
from hotproofs_tpu_torch.ops import msm_pallas as MP

pytestmark = pytest.mark.cuda

DATA = bytes(range(256)) * 4 + bytes(range(100))   # 2 chunks + 100 B
# The reference's proof of chunk 1 of DATA (JAX package, on the CPU).
REF = pathlib.Path(__file__).parent / "data" / "torch_chunk2_proof_ref.json.gz"


@pytest.fixture(scope="module")
def prover():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return CP.ChunkProver(device="cuda")


def test_cli_export_vk_and_verify_with_vk(prover, tmp_path, capsys):
    f = tmp_path / "data.bin"
    f.write_bytes(DATA)
    proof, vk = tmp_path / "proof.json", tmp_path / "vk.json"
    CP.main(["prove", "--file", str(f), "--chunk", "1", "--out", str(proof)])
    CP.main(["export-vk", "--out", str(vk)])
    root = b3.hash_bytes(DATA)
    capsys.readouterr()
    before = MP.launches["msm_bucket"]
    CP.main(["verify", "--proof", str(proof), "--vk", str(vk),
             "--expect-hash", root.hex()])
    assert MP.launches["msm_bucket"] > before
    assert f"VERIFIED (vk-only) root hash: {root.hex()}" in \
        capsys.readouterr().out
    with pytest.raises(AssertionError, match="root hash mismatch"):
        CP.main(["verify", "--proof", str(proof), "--vk", str(vk),
                 "--expect-hash", bytes(32).hex()])


def test_prove_segmented_on_the_card(prover):
    root, sp = prover.prove_segmented(DATA, 1, 2)
    assert [s.num_steps for s in sp.segmented.segments] == [2, 1]
    assert prover.verify_segmented(sp, root) == root
    zs, _, canon, X = prover._device_witness_chain(
        prover._hash_with_path(DATA, 1))
    alone = prover.ivc.prove_batch(zs[2], canon[2:3], X[2:3])
    assert json.dumps(alone.to_dict()) == \
        json.dumps(sp.segmented.segments[1].to_dict())
    # The thread pool (a devices list) gives the lockstep path's bytes.
    _, pool = prover.prove_segmented(DATA, 1, 2, devices=["cuda"])
    assert json.dumps(pool.to_dict()) == json.dumps(sp.to_dict())


def test_reference_chunk_proof_verifies_and_equals_the_port_proof(prover,
                                                                  tmp_path):
    ref = gzip.decompress(REF.read_bytes())
    path = tmp_path / "ref.json"
    path.write_bytes(ref)
    root = b3.hash_bytes(DATA)
    assert prover.verify(CP.ChunkProof.load(str(path)), root) == root
    got, proof = prover.prove(DATA, 1)
    assert got == root
    proof.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == ref


def test_cli_prove_compress_and_verify(prover, tmp_path, capsys):
    """prove --compress writes a compressed chunk proof; verify falls back
    to it; a wrong expected root is refused."""
    f = tmp_path / "data.bin"
    f.write_bytes(DATA)
    out = tmp_path / "cp.json"
    before = (MP.launches["scale16"], MP.launches["fold2"])
    CP.main(["prove", "--file", str(f), "--chunk", "1", "--out", str(out),
             "--compress"])
    assert MP.launches["scale16"] > before[0]
    assert MP.launches["fold2"] > before[1]
    assert json.loads(out.read_text())["kind"] == "compressed_chunk_proof"
    root = b3.hash_bytes(DATA)
    capsys.readouterr()
    CP.main(["verify", "--proof", str(out), "--expect-hash", root.hex()])
    assert f"VERIFIED root hash: {root.hex()}" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="root hash mismatch"):
        CP.main(["verify", "--proof", str(out), "--expect-hash",
                 bytes(32).hex()])


def test_reference_chunk_proof_compresses_and_verifies(prover, tmp_path):
    path = tmp_path / "ref.json"
    path.write_bytes(gzip.decompress(REF.read_bytes()))
    cp = prover.compress(CP.ChunkProof.load(str(path)))
    root = b3.hash_bytes(DATA)
    assert prover.verify_compressed(cp, root) == root
    cp.compressed.spartan.vL = (cp.compressed.spartan.vL + 1) % \
        prover.modulus
    with pytest.raises(AssertionError, match="IPA opening of L failed"):
        prover.verify_compressed(cp, root)


@pytest.mark.parametrize("name", ["toy", "wide"])
def test_spartan_fixture_on_the_card(prover, name, tmp_path):
    """The reference's compressed proofs of tests/spartan_chains.py's
    chains verify on the card, and the port's compression of the same IVC
    proofs equals them byte for byte."""
    from spartan_chains import load_ref, port_stack
    from hotproofs_tpu_torch.nova import spartan as SP
    from hotproofs_tpu_torch.nova.ivc import IVCProof

    ivc, sps, _ = port_stack(name, device="cuda")
    d = load_ref(name)
    assert sps.verify(SP.CompressedProof.from_dict(d["compressed_proof"]),
                      io_arity=1) == [d["z_final"]]
    cp = sps.compress(IVCProof.from_dict(d["ivc_proof"]), io_arity=1)
    cp.save(str(tmp_path / "cp.json"))
    assert (tmp_path / "cp.json").read_text() == \
        json.dumps(d["compressed_proof"])
