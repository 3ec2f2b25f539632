"""The port's Spartan compression (nova/spartan.py) against the reference
on tests/test_spartan.py's toy stack: the fold chain and the compressed
proof byte-equal to the JAX package's, its verifier accepting the
reference's proof and refusing tampered ones without touching the
matrices, the disk cache of the matrix tables refusing a file that
disagrees with the system, and a BN254 round trip.

The reference's Spartan tests compile for minutes on XLA:CPU, so its output
is a committed fixture: tests/data/torch_toy_spartan_ref.json.gz holds its
IVCProof and CompressedProof of the toy chain (key b"toy-spartan", z0 = 5,
4 steps) and tests/data/torch_wide_spartan_ref.json.gz those of a chain of
60 products (6 sum-check rounds and 6-round IPAs; held on the card by
tests/test_torch_cuda_chunk.py and chip_smoke.py, too slow for the CPU
tier). Both are made by the JAX package on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_spartan.py toy|wide OUT.json.gz

and the slow test below makes the toy one again and compares.
"""

import copy
import gzip
import json
import os
import sys

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.circuits import gadgets as g
from hotproofs_tpu_torch.circuits.dsl import eval_witness
from hotproofs_tpu_torch.models.chunk_prover import CompressedChunkProof
from hotproofs_tpu_torch.nova import spartan as SP
from hotproofs_tpu_torch.nova.ivc import IVC, IVCProof
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.utils import telemetry
from hotproofs_tpu_torch.utils.config import CONFIG
from spartan_chains import P, CHAINS, STEPS, key_size, load_ref, \
    port_stack, toy_step

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def make_reference(name: str) -> dict:
    """The JAX package's IVCProof and CompressedProof of chain `name`, as
    the fixture stores them (the compressed proof as its saved document)."""
    return _reference_run(name)[0]


def _reference_run(name: str):
    """(make_reference's dict, the reference's SpartanSystem)."""
    from hotproofs_tpu.circuits import gadgets as rg
    from hotproofs_tpu.circuits.dsl import compile_circuit as r_compile
    from hotproofs_tpu.circuits.dsl import eval_witness as r_eval
    from hotproofs_tpu.nova import serial as r_serial
    from hotproofs_tpu.nova.ivc import IVC as RIVC
    from hotproofs_tpu.nova.pedersen import CommitmentKey as RCK
    from hotproofs_tpu.nova.r1cs import ShapeDevice as RShape
    from hotproofs_tpu.nova.spartan import SpartanSystem as RSpartan
    from hotproofs_tpu.ops import curve as RC

    label, z0, n_steps = CHAINS[name]
    step = lambda ctx: STEPS[name](ctx, rg)
    r1cs, layout = r_compile(step, P)
    shape = RShape.from_dsl(r1cs)
    ivc = RIVC(shape, RC.PALLAS, RCK.create(RC.PALLAS, label,
                                            key_size(shape)), None)
    z, wits = z0, []
    for _ in range(n_steps):
        w = r_eval(step, layout, {"z_in": [z]})
        wits.append(w)
        z = int(w[1]) % P
    proof = ivc.prove([z0], wits)
    # XLA:CPU keeps every compiled program mapped, and a wide chain's
    # prove, compress and verify together need more mappings than the
    # kernel allows a process (vm.max_map_count): free each stage's
    # programs before the next.
    import jax
    jax.clear_caches()
    sps = RSpartan(ivc)
    cp = sps.compress(proof, io_arity=1)
    jax.clear_caches()
    assert sps.verify(cp, io_arity=1) == [z]
    doc = {"format": r_serial._MAGIC, "version": r_serial._VERSION,
           "kind": "compressed_proof"}
    doc.update({"chain": cp.chain.to_dict(), "spartan": cp.spartan.to_dict()})
    return {"ivc_proof": proof.to_dict(), "compressed_proof": doc,
            "z_final": z}, sps


@pytest.fixture(scope="module")
def toy():
    return port_stack("toy")


@pytest.fixture(scope="module")
def ref():
    return load_ref("toy")


@pytest.fixture(scope="module")
def compressed(toy, ref):
    """The port's compression of the reference's IVC proof."""
    _, sps, _ = toy
    return sps.compress(IVCProof.from_dict(ref["ivc_proof"]), io_arity=1)


def test_prove_batch_equals_the_reference_ivc_proof(toy, ref):
    ivc, _, layout = toy
    z, wits = 5, []
    for _ in range(4):
        wits.append(eval_witness(toy_step, layout, {"z_in": [z]}))
        z = int(wits[-1][1]) % P
    spec = ivc.shape.field
    canon = np.stack([spec.batch_to_limbs([int(v) for v in w])
                      for w in wits])
    X = [[int(v) % P for v in w[1:3]] for w in wits]
    proof = ivc.prove_batch([5], canon, X)
    assert json.dumps(proof.to_dict()) == json.dumps(ref["ivc_proof"])
    assert z == ref["z_final"]


def test_compress_is_byte_equal_to_the_reference(toy, ref, compressed,
                                                 tmp_path):
    _, sps, _ = toy
    assert compressed.chain.final_W == [] and compressed.chain.final_E == []
    path = str(tmp_path / "cp.json")
    compressed.save(path)
    with open(path) as f:
        assert f.read() == json.dumps(ref["compressed_proof"])
    assert sps.verify(SP.CompressedProof.load(path), io_arity=1) == \
        [ref["z_final"]]
    # The IPA rounds of the three openings (nz = 8, n_ipa_w = 2, m = 4).
    assert [len(ipa.Ls) for ipa in (compressed.spartan.ipa_L,
                                    compressed.spartan.ipa_W,
                                    compressed.spartan.ipa_E)] == [3, 1, 2]


def test_verify_accepts_the_reference_proof(toy, ref):
    ivc, sps, _ = toy
    cp = SP.CompressedProof.from_dict(ref["compressed_proof"])
    assert sps.verify(cp, io_arity=1) == [ref["z_final"]]
    # The instance-level entry on a bare (shape, curve, key, digest)
    # system, as the recursive SNARK builds one.
    bare = SP.SpartanSystem(shape=ivc.shape, curve=ivc.curve, ck=ivc.ck,
                            pp_digest=ivc.pp_digest)
    bare.verify_relaxed(ivc.fold_instances_only(cp.chain, 1), cp.spartan)


def _bump(v):
    return (v + 1) % P


TAMPERS = {
    "claim": lambda cp: setattr(cp.spartan, "vA", _bump(cp.spartan.vA)),
    "ipa": lambda cp: setattr(cp.spartan.ipa_W, "a_final",
                              _bump(cp.spartan.ipa_W.a_final)),
    "chain": lambda cp: cp.chain.steps[-1].X.__setitem__(
        0, _bump(cp.chain.steps[-1].X[0])),
    "dropped_sumcheck_round": lambda cp: setattr(
        cp.spartan, "sc1_evals", cp.spartan.sc1_evals[:-1]),
    "vL": lambda cp: setattr(cp.spartan, "vL", _bump(cp.spartan.vL)),
}


@pytest.mark.parametrize("case", sorted(TAMPERS))
def test_verify_rejects_tampering(toy, ref, case):
    """tests/test_spartan.py's five negative cases, on the reference's
    proof."""
    _, sps, _ = toy
    cp = SP.CompressedProof.from_dict(copy.deepcopy(ref["compressed_proof"]))
    TAMPERS[case](cp)
    with pytest.raises(AssertionError):
        sps.verify(cp, io_arity=1)


def test_verify_does_not_touch_matrices(toy, ref, monkeypatch):
    """After preprocessing, verify never evaluates the sparse A/B/C (no
    SpMV, no _L_vector): poison them and verify must still pass."""
    _, sps, _ = toy
    sps.preprocess_H()

    def boom(*a, **k):
        raise AssertionError("verifier touched the sparse matrices")
    monkeypatch.setattr(sps, "_L_vector", boom)
    monkeypatch.setattr(sps, "matT", None)
    monkeypatch.setattr(SP, "spmv", boom)
    monkeypatch.setattr(SP, "matvec_all", boom)
    cp = SP.CompressedProof.from_dict(ref["compressed_proof"])
    assert sps.verify(cp, io_arity=1) == [ref["z_final"]]


def test_compressed_chunk_proof_file_round_trip(compressed, tmp_path):
    p = CompressedChunkProof(compressed, chunk_idx=3, n_blocks=16,
                             leaf_depth=2, total_depth=2)
    path = str(tmp_path / "ccp.json")
    p.save(path)
    q = CompressedChunkProof.load(path)
    assert (q.chunk_idx, q.n_blocks, q.leaf_depth, q.total_depth) == \
        (3, 16, 2, 2)
    assert q.compressed.to_dict() == compressed.to_dict()
    with open(path) as f:
        assert json.load(f)["kind"] == "compressed_chunk_proof"


def _counts():
    snap = telemetry.metrics.snapshot()["counters"]
    return {k: snap.get(f"spartan/h_{k}", 0)
            for k in ("builds", "loads", "refused")}


def _rewrite_meta(path, change):
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files}
    meta = json.loads(str(arrs["meta"]))
    change(meta, arrs)
    arrs["meta"] = np.asarray(json.dumps(meta))
    np.savez(path, **arrs)


CACHE_CHANGES = {
    "digest": lambda meta, a: meta.update(
        pp_digest=f"{int(meta['pp_digest'], 16) ^ 1:064x}"),
    "m": lambda meta, a: meta.update(m=meta["m"] * 2),
    "curve": lambda meta, a: meta.update(curve="vesta"),
    "shape": lambda meta, a: a.update(x=a["x"][:, :-1]),
    "stated_shape": lambda meta, a: meta["shapes"].update(inf=[3, 1]),
}


@pytest.mark.parametrize("case", sorted(CACHE_CHANGES))
def test_h_cache_refuses_a_file_that_disagrees(toy, tmp_path, monkeypatch,
                                               case):
    """A cached table file with a changed digest, m, curve or shape is
    refused and rebuilt, never trusted; a good one is loaded."""
    ivc, sps, _ = toy
    monkeypatch.setattr(CONFIG, "cache_dir", str(tmp_path))
    want = SP.SpartanSystem(ivc).preprocess_H()
    path = SP._h_cache_path(ivc.curve, sps.m, ivc.pp_digest)
    assert os.path.basename(path) == \
        f"torch_spartanH_pallas_{sps.m}_{ivc.pp_digest:064x}.npz"
    before = _counts()
    _rewrite_meta(path, CACHE_CHANGES[case])
    got = SP.SpartanSystem(ivc).preprocess_H()
    after = _counts()
    assert after["refused"] == before["refused"] + 1
    assert after["builds"] == before["builds"] + 1
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    SP.SpartanSystem(ivc).preprocess_H()       # the rebuilt file loads
    assert _counts()["loads"] == after["loads"] + 1
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_key_too_small_is_refused(toy):
    ivc, sps, _ = toy
    small = CommitmentKey(ivc.curve, sps.nz // 2,
                          ivc.ck.gens_affine[: sps.nz // 2], b"")
    short = IVC(ivc.shape, ivc.curve, small, None)
    with pytest.raises(ValueError, match=r"has 4 generators, needs 8 = "
                       r"max\(n_ipa_w 2, m 4, nz 8\)"):
        SP.SpartanSystem(short)


BN254_CONST = 11


def bn254_step(ctx, gadgets=g):
    z_out = ctx.declare_output("z_out", 1)
    z_in = ctx.declare_input("z_in", 1, public=True)
    sq = gadgets.mul(ctx, z_in[0], z_in[0], name="sq")
    ctx.bind(z_out[0], sq + BN254_CONST)


def test_bn254_compress_verify_round_trip(monkeypatch):
    """tests/test_bn254_engine.py's toy over BN254 (the reference's default
    engine): the IVC folds, compresses and verifies, a tampered proof is
    refused."""
    monkeypatch.setitem(STEPS, "bn254", bn254_step)
    ivc, sps, layout = port_stack("bn254", C.BN254, b"toy-bn254")
    p = ivc.shape.field.p
    z, wits = 7, []
    for _ in range(3):
        wits.append(eval_witness(bn254_step, layout, {"z_in": [z]}))
        z = (z * z + BN254_CONST) % p
    spec = ivc.shape.field
    canon = np.stack([spec.batch_to_limbs([int(v) for v in w])
                      for w in wits])
    X = [[int(v) % p for v in w[1:3]] for w in wits]
    proof = ivc.prove_batch([7], canon, X)
    assert ivc.verify(proof, io_arity=1) == [z]
    cp = sps.compress(proof, io_arity=1)
    assert cp.chain.final_W == [] and cp.chain.final_E == []
    assert sps.verify(cp, io_arity=1) == [z]
    cp.spartan.vE = (cp.spartan.vE + 1) % p
    with pytest.raises(AssertionError):
        sps.verify(cp, io_arity=1)


@pytest.mark.slow  # the reference's XLA compiles: about 20 minutes on an 8-core CPU
def test_reference_regenerates_the_toy_fixture_and_accepts_the_port(
        toy, tmp_path):
    """The JAX package, run live, gives the committed fixture again, and
    its verifier accepts the port's compressed proof."""
    from hotproofs_tpu.nova.spartan import CompressedProof as RCompressed

    live, rsps = _reference_run("toy")
    assert json.dumps(live) == json.dumps(load_ref("toy"))
    _, sps, _ = toy
    mine = sps.compress(IVCProof.from_dict(live["ivc_proof"]), io_arity=1)
    path = str(tmp_path / "port.json")
    mine.save(path)
    assert rsps.verify(RCompressed.load(path), io_arity=1) == \
        [live["z_final"]]


if __name__ == "__main__":
    doc = make_reference(sys.argv[1])
    with gzip.open(sys.argv[2], "wt") as f:
        json.dump(doc, f)
