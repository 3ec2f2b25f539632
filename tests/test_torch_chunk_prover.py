"""The port's chunk prover: the blake3-chunk pp digest equals the
reference's, the package imports and proves with jax blocked, the CLI's
unported option (--compress) refuses, the reference's real-size proof of a
2-block chunk (tests/data) reads back byte for byte, and (slow) a live
2-block chunk proof is byte-equal to the reference's and accepted by its
verifier."""

import gzip
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.core import blake3_ref as b3
from hotproofs_tpu_torch.models import chunk_prover as CP

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "hotproofs_tpu_torch"


def test_blake3_chunk_pp_digest_matches_reference():
    from hotproofs_tpu.models import chunk_prover as RCP

    ivc, _, _ = CP._build_stack("pallas", 8, "cpu")
    ref, _, _ = RCP._build_stack()
    assert (ivc.shape.n_cons, ivc.shape.n_vars, ivc.ck.n) == \
        (ref.shape.n_cons, ref.shape.n_vars, ref.ck.n)
    assert list(ivc.big_wit_idx) == list(ref.big_wit_idx)
    assert ivc.pp_digest == ref.pp_digest


_JAX_BLOCKED = r"""
import sys
sys.modules["jax"] = None
import importlib, pkgutil
import hotproofs_tpu_torch
for m in pkgutil.walk_packages(hotproofs_tpu_torch.__path__,
                               "hotproofs_tpu_torch."):
    importlib.import_module(m.name)
from hotproofs_tpu.circuits import gadgets as g
from hotproofs_tpu.circuits.dsl import compile_circuit, eval_witness
from hotproofs_tpu.circuits.blake3_compression import VESTA_PRIME as P
import numpy as np
from hotproofs_tpu_torch.nova.ivc import IVC
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.nova.r1cs import ShapeDevice
from hotproofs_tpu_torch.ops import curve as C, field as F

def step(ctx):
    z_out = ctx.declare_output("z_out", 1)
    z_in = ctx.declare_input("z_in", 1, public=True)
    sq = g.mul(ctx, z_in[0], z_in[0], name="sq")
    ctx.bind(z_out[0], sq + 1)

r1cs, layout = compile_circuit(step, P)
shape = ShapeDevice.from_dsl(r1cs)
ivc = IVC(shape, C.PALLAS, CommitmentKey.create(C.PALLAS, b"", 4), None)
z, wits = 2, []
for _ in range(2):
    wits.append(eval_witness(step, layout, {"z_in": [z]}))
    z = (z * z + 1) % P
canon = np.stack([F.pallas_scalar.batch_to_limbs([int(v) for v in w])
                  for w in wits])
proof = ivc.prove_batch([2], canon, [[int(v) for v in w[1:3]] for w in wits])
assert ivc.verify(proof, io_arity=1) == [z]
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("JAX-FREE OK")
"""


def test_imports_and_proves_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO),
               HOTPROOFS_CACHE=str(tmp_path), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _JAX_BLOCKED], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX-FREE OK" in res.stdout


def test_no_jax_import_in_package():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax")
                        or s.startswith("from jax")), f"{path}: {s}"


@pytest.mark.parametrize("argv", [["prove", "--file", "x", "--compress"]])
def test_cli_unported_options_exit_nonzero(argv, monkeypatch):
    """No CLI option answers "not ported yet" any more (`--compress` is
    ported with nova/spartan.py); without a card its default device
    raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device") as e:
        CP.main(argv)
    assert "not ported" not in str(e.value)


def test_designs_tool_times_the_w_batch_prove_many_commits(monkeypatch):
    """tools/msm_designs.py's W shapes take the batch prove_many commits
    at 40 bits (full-width positions zeroed), whose digits are mostly
    zero, unlike uniform random scalars'."""
    from hotproofs_tpu_torch.tools import msm_designs as D

    class Committed(Exception):
        pass

    def commit_many_split(w, big_idx):
        seen.append(w.clone())
        raise Committed

    seen = []
    prover = CP.ChunkProver(device="cpu")
    monkeypatch.setattr(prover.ivc, "prepare_key", lambda: None)
    monkeypatch.setattr(prover.ivc.ck, "commit_many_split", commit_many_split)
    data = bytes(range(256)) * 8 + bytes(range(100))    # 2 chunks + 100 B
    with pytest.raises(Committed):
        prover.prove_many(data, [1, 0])
    w = D.witness_scalars(prover, data, [1, 0])
    assert w.shape == (2 * D.STEPS, prover.ivc.shape.n_wit, 32)
    want = seen[0].clone()
    want[:, torch.as_tensor(prover.ivc.big_wit_idx)] = 0
    assert torch.equal(w, want)
    assert not bool((w[..., 5:] != 0).any())            # all < 2^40
    rand = D.random_scalars(np.random.default_rng(0), 2, 1000, 40, "cpu")
    assert D.nonzero_share(w, 40) < 0.5 < D.nonzero_share(rand, 40)


REF_CHUNK2 = REPO / "tests" / "data" / "torch_chunk2_proof_ref.json.gz"
CHUNK2_DATA = bytes(range(256)) * 4 + bytes(range(100))   # 2 chunks


def test_reference_chunk_proof_reads_back_byte_for_byte(tmp_path):
    """The reference's real-size proof of chunk 1 of CHUNK2_DATA (made by
    the JAX package's ChunkProver().prove on the CPU) loads into the
    port's ChunkProof and saves to the same bytes; its statement and final
    state give the BLAKE3 root. Verifying it needs the full-width key,
    which the card prepares in seconds (tests/test_torch_cuda_chunk.py)."""
    ref = gzip.decompress(REF_CHUNK2.read_bytes())
    path, again = tmp_path / "ref.json", tmp_path / "again.json"
    path.write_bytes(ref)
    proof = CP.ChunkProof.load(str(path))
    proof.save(str(again))
    assert again.read_bytes() == ref
    p = CP.ChunkProver(device="cpu")
    ip = proof.ivc_proof
    CP.check_statement(p.modulus, ip.z0, ip.num_steps, proof.chunk_idx,
                       proof.n_blocks, proof.leaf_depth, proof.total_depth)
    assert (proof.chunk_idx, ip.num_steps) == (1, 3)
    assert ip.pp_digest == p.ivc.pp_digest
    assert CP.check_final(ip.z_final(CP.IO_ARITY), proof.n_blocks,
                          b3.hash_bytes(CHUNK2_DATA)) \
        == b3.hash_bytes(CHUNK2_DATA)


@pytest.mark.slow  # full-width key preparation on the CPU + reference prove
def test_two_block_chunk_byte_equal_and_cross_verified(tmp_path):
    from hotproofs_tpu.models import chunk_prover as RCP

    data = bytes(range(256)) * 4 + bytes(range(100))   # 2 chunks
    f = tmp_path / "data.bin"
    f.write_bytes(data)
    out = tmp_path / "port.json"
    CP.main(["prove", "--file", str(f), "--chunk", "1", "--out", str(out),
             "--device", "cpu"])
    ref_prover = RCP.ChunkProver()
    root, ref_proof = ref_prover.prove(data, 1)
    ref_out = tmp_path / "ref.json"
    ref_proof.save(str(ref_out))
    assert out.read_bytes() == ref_out.read_bytes()
    port_proof = RCP.ChunkProof.load(str(out))
    assert ref_prover.verify(port_proof, root) == root
    CP.main(["verify", "--proof", str(ref_out), "--expect-hash",
             root.hex(), "--device", "cpu"])
    assert json.loads(out.read_text())["chunk_idx"] == 1
