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


def test_cli_prove_compress_and_verify(prover, tmp_path, capsys,
                                      monkeypatch):
    """prove --compress writes a compressed chunk proof whose three IPAs
    commit once a round over the key's prepared bases (msm_bucket once a
    round, no scale16 or to_affine inside them); verify falls back to it; a
    wrong expected root is refused."""
    from hotproofs_tpu_torch.nova import spartan as SP

    ipas = []
    prove = SP._IPA.prove_weighted

    def counted(self, *args):
        before = {k: MP.launches[k]
                  for k in ("msm_bucket", "scale16", "to_affine")}
        out = prove(self, *args)
        ipas.append((len(out[0].Ls), {k: MP.launches[k] - v
                                      for k, v in before.items()}))
        return out

    monkeypatch.setattr(SP._IPA, "prove_weighted", counted)
    f = tmp_path / "data.bin"
    f.write_bytes(DATA)
    out = tmp_path / "cp.json"
    CP.main(["prove", "--file", str(f), "--chunk", "1", "--out", str(out),
             "--compress"])
    assert len(ipas) == 3
    for rounds, launched in ipas:
        assert launched == {"msm_bucket": rounds, "scale16": 0,
                            "to_affine": 0}
    assert json.loads(out.read_text())["kind"] == "compressed_chunk_proof"
    root = b3.hash_bytes(DATA)
    capsys.readouterr()
    CP.main(["verify", "--proof", str(out), "--expect-hash", root.hex()])
    assert f"VERIFIED root hash: {root.hex()}" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="root hash mismatch"):
        CP.main(["verify", "--proof", str(out), "--expect-hash",
                 bytes(32).hex()])


def test_compress_after_setup_launches_no_scale16_or_to_affine(prover):
    """After SpartanSystem.setup, compress and verify_compressed launch no
    scale16 and no to_affine, and compress launches msm_bucket once per IPA
    round and once for the commitment to L."""
    from hotproofs_tpu_torch.utils import telemetry as T_

    rounds = lambda: T_.metrics.snapshot().get("spartan/ipa_rounds", 0)
    root, proof = prover.prove(DATA, 1)
    prover.spartan.setup()
    before, r0 = dict(MP.launches), rounds()
    cp = prover.compress(proof)
    buckets = MP.launches["msm_bucket"] - before["msm_bucket"]
    assert prover.verify_compressed(cp, root) == root
    assert buckets == rounds() - r0 + 1
    for k in ("scale16", "to_affine"):
        assert MP.launches[k] == before[k], k


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


def test_per_step_and_resume_on_the_card(prover, tmp_path):
    """fast=False (the per-step IVC.prove) and a chain resumed from its
    checkpoint give the batched proof's bytes."""
    from hotproofs_tpu_torch.nova.ivc import ProverCheckpoint

    root, fast = prover.prove(DATA, 1)
    _, slow = prover.prove(DATA, 1, fast=False)
    assert json.dumps(slow.to_dict()) == json.dumps(fast.to_dict())
    _, sched, canon, X = prover._device_witness_chain(
        prover._hash_with_path(DATA, 1))
    path = str(tmp_path / "ckpt.json")
    whole = prover.ivc.prove_batch(sched.z0, canon, X, checkpoint_every=1,
                                   checkpoint_path=path)
    assert json.dumps(whole.to_dict()) == json.dumps(fast.ivc_proof.to_dict())
    fresh = CP.ChunkProver(device="cuda")
    resumed = fresh.ivc.prove_batch(sched.z0, canon, X,
                                    resume=ProverCheckpoint.load(path))
    assert json.dumps(resumed.to_dict()) == json.dumps(whole.to_dict())


def test_one_rank_nccl_mesh_gives_the_same_bytes(prover, monkeypatch):
    """A one-rank NCCL group (the card machine has one H100): prove_batch
    on a 1x1 mesh and prove_lockstep on a one-rank chain mesh equal the
    runs without a mesh."""
    import socket

    from hotproofs_tpu_torch.parallel import mesh as M

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("HOTPROOFS_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("HOTPROOFS_NUM_PROCESSES", "1")
    monkeypatch.setenv("HOTPROOFS_PROCESS_ID", "0")
    assert M.init_distributed() == 0
    try:
        assert torch.distributed.get_backend() == "nccl"
        _, want = prover.prove(DATA, 1)
        _, got = prover.prove(DATA, 1, mesh=M.make_mesh(1, 1))
        assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
        _, many = prover.prove_many(DATA, [1, 0])
        chains = []
        for ci in (1, 0):
            _, sched, canon, X = prover._device_witness_chain(
                prover._hash_with_path(DATA, ci))
            chains.append((sched.z0, canon, X))
        mesh_many = prover.ivc.prove_lockstep(chains,
                                              mesh=M.make_chain_mesh())
        assert [json.dumps(p.to_dict()) for p in mesh_many] == \
            [json.dumps(p.ivc_proof.to_dict()) for p in many]
    finally:
        torch.distributed.destroy_process_group()
