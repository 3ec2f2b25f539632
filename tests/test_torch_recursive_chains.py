"""The port's recursive SNARK proves and verifies whole chains with the
reference tests' commitment oracle (tests/test_recursive.py): the toy chain
on Pasta byte-equal to the reference's (tests/data/
torch_toy_recursive_oracle_ref.json.gz, made by the JAX package on the CPU
with the same oracle), its verifier accepting that fixture and refusing
tampered copies, both packages reading each other's proof files, and a
BN254/Grumpkin chain. The reference's proof of the 2-step chain with real
commitments (tests/data/torch_toy_recursive_ref.json.gz) passes every
check here but its commitments, which the card checks.

Make the fixtures again (oracle: about 6 minutes of XLA:CPU compiles and
runs; toy, real commitments: about 2.6 hours on an 8-core CPU):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_recursive_fixtures.py oracle|toy OUT.json.gz

The slow test below makes the oracle one again and compares.
"""

import copy
import json
import re

import pytest
import torch

from hotproofs_tpu_torch.nova import recursive as R
from hotproofs_tpu_torch.ops import curve as C
from test_torch_recursive_fixtures import (CHAINS, Z0, load_ref, make_reference,
                              oracle_commits, port_snark, toy_host)

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def snark():
    s = port_snark()
    with oracle_commits(s, C):
        yield s


@pytest.fixture(scope="module")
def proof(snark):
    return snark.prove(Z0, n_steps=CHAINS["oracle"][1])


def _cube_chain(q, n):
    z = list(Z0)
    for _ in range(n):
        z = toy_host(q)(z)
    return z


def test_oracle_chain_is_byte_equal_to_the_reference(snark, proof):
    assert json.dumps(proof.to_dict()) == json.dumps(load_ref("oracle"))
    assert len(snark.timings) == 3 and all(
        t["synth_primary"] > 0 and t["device"] > 0 for t in snark.timings)


def test_verifier_accepts_the_reference_fixture(snark):
    ref = R.RecursiveProof.from_dict(load_ref("oracle"))
    assert snark.verify(ref) == _cube_chain(snark.q, 3)


def _swap_U1(bad):
    bad.U1.comm_W, bad.U1.comm_E = bad.U1.comm_E, bad.U1.comm_W


def _bump_z(bad, q):
    bad.z_final = [(bad.z_final[0] + 1) % q]


def _bump_W1(bad, q):
    bad.W1[5] = (bad.W1[5] + 1) % q


@pytest.mark.parametrize("tamper,why", [
    (lambda b, q: _bump_z(b, q), "primary state hash mismatch"),
    (lambda b, q: _swap_U1(b), "secondary state hash mismatch"),
    (lambda b, q: _bump_W1(b, q), "comm_W mismatch (primary)"),
], ids=["z_final", "U1-commitments-swapped", "W1-entry"])
def test_verifier_refuses_tampered_fixture(snark, tamper, why):
    bad = R.RecursiveProof.from_dict(load_ref("oracle"))
    tamper(bad, snark.q)
    with pytest.raises(AssertionError, match=re.escape(why)):
        snark.verify(bad)


def test_real_commit_fixture_holds_but_for_its_commitments(snark):
    """The reference's proof with real Pedersen commitments (tests/data/
    torch_toy_recursive_ref.json.gz, 2 steps): the port's verifier holds
    its state hashes and all three R1CS relations, with each commitment
    taken as the proof claims it; the card checks the commitments
    themselves (tests/test_torch_cuda_recursive.py, chip_smoke.py)."""
    ref = R.RecursiveProof.from_dict(load_ref("toy"))
    claimed = iter([ref.U1.comm_W, ref.U1.comm_E, ref.U2.comm_W,
                    ref.U2.comm_E, ref.u1.comm_W])
    sides = (snark.side1, snark.side2)
    oracles = [side.commit for side in sides]
    try:
        for side in sides:
            side.commit = lambda vec: next(claimed)
        assert snark.verify(ref) == _cube_chain(snark.q, 2)
        assert next(claimed, None) is None
        ref.E2[4] = (ref.E2[4] + 1) % snark.p
        claimed = iter([ref.U1.comm_W, ref.U1.comm_E, ref.U2.comm_W,
                        ref.U2.comm_E])
        with pytest.raises(AssertionError,
                           match=re.escape("relaxed R1CS unsatisfied "
                                           "(secondary)")):
            snark.verify(ref)
    finally:
        for side, commit in zip(sides, oracles):
            side.commit = commit


def test_files_read_across_packages(proof, tmp_path):
    """The port's saved proof loads in the reference and back, unchanged;
    so does the reference's."""
    from hotproofs_tpu.nova import recursive as RR
    path = str(tmp_path / "port.json")
    proof.save(path)
    ref = RR.RecursiveProof.load(path)
    assert json.dumps(ref.to_dict()) == json.dumps(proof.to_dict())
    back = str(tmp_path / "ref.json")
    ref.save(back)
    with open(path) as a, open(back) as b:
        assert a.read() == b.read()
    assert json.dumps(R.RecursiveProof.load(back).to_dict()) == \
        json.dumps(proof.to_dict())


def test_bn254_oracle_chain_proves_and_verifies():
    """Two steps of the augmented construction on BN254/Grumpkin (b = -17
    on the secondary's curve, 254-bit scalars)."""
    s = port_snark(("bn254", "grumpkin"), b"test-recursive-bn")
    with oracle_commits(s, C):
        p2 = s.prove(Z0, n_steps=2)
        assert s.verify(p2) == _cube_chain(s.q, 2)
        bad = copy.deepcopy(p2)
        _bump_z(bad, s.q)
        with pytest.raises(AssertionError, match="state hash"):
            s.verify(bad)


@pytest.mark.slow  # the reference's XLA compiles: about 6 minutes on an 8-core CPU
def test_reference_regenerates_the_oracle_fixture():
    assert json.dumps(make_reference("oracle")) == \
        json.dumps(load_ref("oracle"))
