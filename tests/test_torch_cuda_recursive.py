"""The recursive SNARK on the card with real commitments: the reference
tests' toy chain on Pasta and on BN254/Grumpkin (2 steps each), the Pasta
one byte-equal to the reference's proof where tests/data holds it
(tests/data/torch_toy_recursive_ref.json.gz), and ChunkProver's 1-block
prove_recursive; every commitment of the chains is held against the plain
versions of msm_bucket, msm_merge and msm_wsum on its own scalars.

Marked `cuda`: without a CUDA device each test skips (the decision is made
inside the fixture, never at import). On a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda_recursive.py -q -m cuda
"""

import contextlib
import json
import os

import pytest
import torch

from hotproofs_tpu_torch.core import blake3_ref as b3
from hotproofs_tpu_torch.models import chunk_prover as CP
from hotproofs_tpu_torch.ops import msm_pallas as MP
from test_torch_recursive_fixtures import (CHAINS, LABEL, Z0, load_ref, port_snark,
                              ref_path, toy_host)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@contextlib.contextmanager
def commits_checked(counts: dict):
    """While active, every msm_many call runs its kernels and then their
    plain versions on the same digits, and must agree; counts['msm'] counts
    the calls."""
    msm_many = MP.msm_many

    def checked(spec, scalars, bases, m, max_bits, b=None, bases_lm=None):
        b, lpw, w4, _ = MP.plan(m, max_bits, b)
        d = MP.digits_tm(scalars, m, b, lpw, w4)
        bk = MP.msm_bucket(spec, d, bases, bases_lm)
        assert torch.equal(bk, MP.msm_bucket_plain(spec, d, bases))
        red = MP.msm_merge(spec, bk)
        assert torch.equal(red, MP.msm_merge_plain(spec, bk))
        s = MP.msm_wsum(spec, red)
        assert torch.equal(s, MP.msm_wsum_plain(spec, red))
        counts["msm"] = counts.get("msm", 0) + 1
        return msm_many(spec, scalars, bases, m, max_bits, b, bases_lm)

    MP.msm_many = checked
    try:
        yield
    finally:
        MP.msm_many = msm_many


@pytest.mark.parametrize("cycle,label", [
    (("pallas", "vesta"), LABEL),
    (("bn254", "grumpkin"), b"test-recursive-bn")], ids=["pasta", "bn254"])
def test_toy_chain_with_real_commits(dev, cycle, label):
    snark = port_snark(cycle, label, device=dev)
    counts: dict = {}
    before = MP.launches["msm_bucket"]
    with commits_checked(counts):
        proof = snark.prove(Z0, n_steps=CHAINS["toy"][1])
    assert MP.launches["msm_bucket"] > before and counts["msm"] >= 6
    z = Z0
    for _ in range(proof.n_steps):
        z = toy_host(snark.q)(z)
    assert snark.verify(proof) == z
    if cycle[0] == "pallas" and os.path.exists(ref_path("toy")):
        ref = load_ref("toy")
        assert json.dumps(proof.to_dict()) == json.dumps(ref)
        assert snark.verify(type(proof).from_dict(ref)) == z
    bad = type(proof).from_dict(proof.to_dict())
    bad.W2[3] = (bad.W2[3] + 1) % snark.p
    with pytest.raises(AssertionError, match="comm_W mismatch"):
        snark.verify(bad)


def test_chunk_prove_recursive_on_the_card(dev):
    prover = CP.ChunkProver(device=dev)
    data = bytes([7] * 10)
    counts: dict = {}
    with commits_checked(counts):
        root, proof = prover.prove_recursive(data, 0)
    assert root == b3.hash_bytes(data) and counts["msm"] == 3
    assert prover.verify_recursive(proof, expected_hash=root) == root
    proof.chunk_idx = 1
    with pytest.raises(AssertionError, match="z0 mismatch"):
        prover.verify_recursive(proof)
