"""The chunk prover on the card: the verification key through the CLI,
segments, and the reference's real-size proof (verified, and equal to the
port's proof of the same chunk byte for byte).

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
