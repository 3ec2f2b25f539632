"""The port's compressed recursive proof (nova/recursive.py:
RecursiveSNARK.compress / verify_compressed, CompressedRecursiveProof)
against the JAX package's, on the reference's 2-step toy proof with real
commitments (tests/data/torch_toy_recursive_ref.json.gz).

Each Spartan argument runs at the augmented circuits' full width (m =
32,768), which the card does (tests/test_torch_cuda_recursive.py,
chip_smoke.py). Here both packages' SNARKs get the same recording stub in
place of _spartan(side): it keeps every claim handed to prove_relaxed and
verify_relaxed and answers with a fixed Spartan proof (the reference's toy
one, tests/data/torch_toy_spartan_ref.json.gz, its vL set to the call's
index). So the three claims (instance, W and E), the calls that
verify_compressed makes and the proof files are compared exactly.

The reference's RecursiveSNARK.__init__ derives both 32,768-generator keys
(minutes on this CPU), which compress and verify_compressed do not read:
its methods run here on an instance made without __init__, with the
fields they read (the vk, the fields' Poseidon specs, each side's n_io and
n_cons) taken from the port's SNARK, whose vk and shapes equal the
reference's (tests/test_torch_recursive.py, test_torch_recursive_chunk.py).
"""

import copy
import json
import re
from types import SimpleNamespace

import pytest
import torch

from hotproofs_tpu_torch.nova import recursive as R
from hotproofs_tpu_torch.nova.spartan import SpartanProof
from spartan_chains import load_ref as load_spartan_ref
from test_torch_recursive_fixtures import (compressed_path, load_ref,
                                           port_snark,
                                           reference_verifies_compressed)

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


class Recorder:
    """Stands in for a side's SpartanSystem: logs each claim, answers
    with the fixed proof (of the package's own SpartanProof class)."""

    def __init__(self, log, side, proof_cls):
        self.log, self.side, self.proof_cls = log, side, proof_cls
        self.timings = {}

    @staticmethod
    def _inst(inst):
        return (int(inst.u), [int(x) for x in inst.X], inst.comm_W,
                inst.comm_E)

    def prove_relaxed(self, inst, W, E):
        self.log.append(("prove", self.side, self._inst(inst),
                         [int(v) for v in W], [int(v) for v in E]))
        doc = copy.deepcopy(load_spartan_ref("toy")["compressed_proof"][
            "spartan"])
        doc["vL"] = len(self.log)
        return self.proof_cls.from_dict(doc)

    def verify_relaxed(self, inst, sp):
        self.log.append(("verify", self.side, self._inst(inst),
                         json.dumps(sp.to_dict())))


def _stub(snark, proof_cls):
    log = []
    stubs = {side.name: Recorder(log, side.name, proof_cls)
             for side in (snark.side1, snark.side2)}
    snark._spartan = lambda side: stubs[side.name]
    return log


def _reference_shell(port):
    """The JAX package's RecursiveSNARK without __init__ (module
    docstring), with the fields compress and verify_compressed read."""
    from hotproofs_tpu.nova import recursive as RR
    from hotproofs_tpu.ops import poseidon as RP
    ref = RR.RecursiveSNARK.__new__(RR.RecursiveSNARK)
    ref.q, ref.p, ref.vk = port.q, port.p, port.vk
    ref.pspec1 = RP.make_spec(port.side1.curve.scalar.name)
    ref.pspec2 = RP.make_spec(port.side2.curve.scalar.name)
    ref.side1, ref.side2 = (
        SimpleNamespace(name=s.name, shape=SimpleNamespace(
            n_io=s.shape.n_io, n_cons=s.shape.n_cons))
        for s in (port.side1, port.side2))
    return ref


@pytest.fixture(scope="module")
def snarks():
    """(port SNARK, reference shell, port log, reference log)."""
    from hotproofs_tpu.nova.spartan import SpartanProof as RSpartanProof
    port = port_snark()
    ref = _reference_shell(port)
    return port, ref, _stub(port, SpartanProof), _stub(ref, RSpartanProof)


@pytest.fixture(scope="module")
def compressed(snarks):
    """Both packages' compressions of the reference's toy proof, and the
    claims each handed to Spartan."""
    from hotproofs_tpu.nova import recursive as RR
    port, ref, plog, rlog = snarks
    doc = load_ref("toy")
    mine = port.compress(R.RecursiveProof.from_dict(doc))
    theirs = ref.compress(RR.RecursiveProof.from_dict(doc))
    claims = (list(plog), list(rlog))
    plog.clear()
    rlog.clear()
    return mine, theirs, claims


def test_the_three_claims_equal_the_reference(snarks, compressed):
    port, _, _, _ = snarks
    mine, theirs, (plog, rlog) = compressed
    assert plog == rlog
    assert [(c[0], c[1]) for c in plog] == [
        ("prove", "primary"), ("prove", "secondary"), ("prove", "primary")]
    rec = R.RecursiveProof.from_dict(load_ref("toy"))
    s1 = port.side1.shape
    # The u1 claim: u = 1, comm_E the identity, the witness after (1, X),
    # E all zero.
    assert plog[2][2] == (1, list(rec.u1.X), rec.u1.comm_W, None)
    assert plog[2][3] == rec.w1[1 + s1.n_io:] and len(plog[2][3]) == s1.n_wit
    assert plog[2][4] == [0] * s1.n_cons
    assert plog[0][3:] == (rec.W1, rec.E1) and plog[1][3:] == (rec.W2,
                                                              rec.E2)
    assert json.dumps(mine.to_dict()) == json.dumps(theirs.to_dict())
    assert [sp.vL for sp in (mine.sp1, mine.sp2, mine.sp_u1)] == [1, 2, 3]


def test_verify_compressed_makes_the_reference_calls(snarks, compressed):
    port, ref, plog, rlog = snarks
    mine, theirs, _ = compressed
    z = port.verify_compressed(mine)
    assert ref.verify_compressed(theirs) == z == \
        R.RecursiveProof.from_dict(load_ref("toy")).z_final
    assert plog == rlog
    assert [(c[0], c[1], json.loads(c[3])["vL"]) for c in plog] == [
        ("verify", "primary", 1), ("verify", "secondary", 2),
        ("verify", "primary", 3)]
    plog.clear()
    rlog.clear()


def test_files_read_across_packages(compressed, tmp_path):
    from hotproofs_tpu.nova import recursive as RR
    mine, theirs, _ = compressed
    path, back = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    mine.save(path)
    RR.CompressedRecursiveProof.load(path).save(back)
    with open(path) as a, open(back) as b:
        text = a.read()
        assert text == b.read()
    assert json.loads(text)["kind"] == "compressed_recursive_proof"
    theirs.save(back)
    assert json.dumps(R.CompressedRecursiveProof.load(back).to_dict()) == \
        json.dumps(mine.to_dict())


def _bump(v, q):
    return (v + 1) % q


TAMPERS = {
    "z_final": lambda cp, q: setattr(cp, "z_final",
                                     [_bump(cp.z_final[0], q)]),
    "n_steps": lambda cp, q: setattr(cp, "n_steps", cp.n_steps + 1),
    "u1.X[0]": lambda cp, q: setattr(cp.u1, "X",
                                     (_bump(cp.u1.X[0], q), cp.u1.X[1])),
    "U1.u": lambda cp, q: setattr(cp.U1, "u", _bump(cp.U1.u, q)),
}
WHY = {"U1.u": "secondary state hash mismatch"}


@pytest.mark.parametrize("case", sorted(TAMPERS))
def test_verify_compressed_refuses_before_any_spartan_verify(
        snarks, compressed, case):
    """A changed z_final, n_steps or u1.X[0] fails the primary state hash
    and a changed U1 the secondary, with the reference's messages, and no
    Spartan argument is verified."""
    port, ref, plog, rlog = snarks
    mine, theirs, _ = compressed
    why = WHY.get(case, "primary state hash mismatch")
    for snark, cp, log in ((port, mine, plog), (ref, theirs, rlog)):
        bad = copy.deepcopy(cp)
        TAMPERS[case](bad, port.q)
        with pytest.raises(AssertionError, match=re.escape(why)):
            snark.verify_compressed(bad)
        assert log == []


def test_the_committed_compressed_proof_reads_in_both_packages(snarks):
    """The port's compressed proof of the reference's toy chain, made on
    the card (tests/data/torch_toy_recursive_compressed.json.gz): both
    packages read it to the same document, it carries the recursive
    proof's instances, and verify_compressed hands the same claims to
    Spartan in both."""
    import gzip

    from hotproofs_tpu.nova import recursive as RR
    port, ref, plog, rlog = snarks
    with gzip.open(compressed_path(), "rt") as f:
        text = f.read()
    doc = json.loads(text)
    assert doc["kind"] == "compressed_recursive_proof"
    doc = {k: v for k, v in doc.items()
           if k not in ("format", "version", "kind")}
    mine = R.CompressedRecursiveProof.from_dict(doc)
    theirs = RR.CompressedRecursiveProof.from_dict(doc)
    assert json.dumps(mine.to_dict()) == json.dumps(theirs.to_dict()) == \
        json.dumps(doc)
    rec = load_ref("toy")
    assert all(doc[k] == rec[k] for k in ("n_steps", "z0", "z_final", "U1",
                                          "U2", "u1"))
    assert all(pt is None for pt in mine.sp_u1.ipa_E.Ls
               + mine.sp_u1.ipa_E.Rs)
    assert port.verify_compressed(mine) == ref.verify_compressed(theirs) \
        == rec["z_final"]
    assert plog == rlog and len(plog) == 3
    plog.clear()
    rlog.clear()


@pytest.mark.slow  # the reference's XLA:CPU compiles: hours on an 8-core CPU
def test_reference_verifies_the_port_compressed_proof():
    assert reference_verifies_compressed() == load_ref("toy")["z_final"]
