"""ChunkProver's recursive proofs on the CPU (prove_recursive /
verify_recursive, RecursiveChunkProof): the recursive SNARK over the
BLAKE3 step has the reference's verification key, and the reference tests'
1-block chunk proves and verifies with the commitment oracle
(tests/test_torch_recursive_fixtures.py), and is refused with another chunk index."""

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.core import blake3_ref as b3
from hotproofs_tpu_torch.models.chunk_prover import (ChunkProver,
                                                     RecursiveChunkProof)
from hotproofs_tpu_torch.ops import curve as C
from test_torch_recursive_fixtures import oracle_commits

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

DATA = bytes([7] * 10)      # 1 block, leaf depth 1: one recursive step


@pytest.fixture(scope="module")
def prover():
    return ChunkProver(device="cpu")


def _reference_vk(label: bytes) -> int:
    """The reference's vk of the BLAKE3 recursive SNARK on Pasta, computed
    from its own probe circuits as its RecursiveSNARK.__init__ does
    (hotproofs_tpu/nova/recursive.py:425-449)."""
    from hotproofs_tpu.circuits import blake3_nova as rn
    from hotproofs_tpu.circuits import nova_augmented as RNA
    from hotproofs_tpu.circuits.dsl import compile_circuit
    from hotproofs_tpu.nova.transcript import digest_of
    from hotproofs_tpu.ops import curve as RC
    from hotproofs_tpu.ops import poseidon as RP

    cur1, cur2 = RC.PALLAS, RC.VESTA
    q, p = cur1.scalar.p, cur2.scalar.p
    c1 = RNA.make_augmented_circuit(
        RP.make_spec(cur1.scalar.name), cur2.b, p, 0, rn.IO_ARITY,
        lambda ctx, z, e: rn.nova_step_body(ctx, z, e, 0, 8),
        fold_at_base=True, f_extra_decl=rn.declare_step_inputs)
    c2 = RNA.make_augmented_circuit(RP.make_spec(cur2.scalar.name), cur1.b,
                                    q, 0, 0, None, fold_at_base=False)

    def mat_bytes(r1cs):
        parts = []
        for rows, cols, vals in (r1cs.A, r1cs.B, r1cs.C):
            parts.append(b"".join(
                int(r_).to_bytes(4, "little") + int(c_).to_bytes(4, "little")
                + (int(v_) % (1 << 256)).to_bytes(32, "little")
                for r_, c_, v_ in zip(rows, cols, vals)))
        parts.append(np.asarray([r1cs.n_constraints, r1cs.n_signals,
                                 r1cs.n_io], np.int64).tobytes())
        return b"".join(parts)

    r1, _ = compile_circuit(c1, q)
    r2, _ = compile_circuit(c2, p)
    return digest_of(label, mat_bytes(r1), mat_bytes(r2)) \
        % (1 << RNA.CHALLENGE_BITS)


def test_blake3_rec_vk_equals_the_reference(prover):
    rs = prover.recursive
    assert rs.vk == _reference_vk(b"blake3-rec")
    assert (rs.side1.n_pad, rs.side2.n_pad) == (65536, 32768)
    assert (rs.side1.curve, rs.side2.curve) == (C.PALLAS, C.VESTA)


def test_prove_recursive_one_block_verifies(prover, tmp_path):
    with oracle_commits(prover.recursive, C):
        root, proof = prover.prove_recursive(DATA, 0)
        assert root == b3.hash_bytes(DATA)
        assert proof.rec.n_steps == 1
        assert prover.verify_recursive(proof, expected_hash=root) == root
        path = str(tmp_path / "rec_chunk.json")
        proof.save(path)
        back = RecursiveChunkProof.load(path)
        assert back.rec.to_dict() == proof.rec.to_dict()
        back.chunk_idx = 1
        with pytest.raises(AssertionError, match="z0 mismatch"):
            prover.verify_recursive(back)
