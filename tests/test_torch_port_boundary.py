"""The port stands alone: no module of hotproofs_tpu_torch (nor
chip_smoke.py) imports the JAX package or jax, its copies of the
reference's host modules give the reference's outputs, and its entry
points run on the card unless asked for the CPU."""

import ast
import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hotproofs_tpu.circuits import blake3_nova as R_nova
from hotproofs_tpu.core import blake3_ref as R_b3
from hotproofs_tpu.core import native as R_native
from hotproofs_tpu.core import native_ff as R_native_ff
from hotproofs_tpu_torch.circuits import blake3_nova as nova
from hotproofs_tpu_torch.core import blake3_ref as b3
from hotproofs_tpu_torch.core import native, native_ff
from hotproofs_tpu_torch.models import chunk_prover as CP
from hotproofs_tpu_torch.nova.transcript import Transcript
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import poseidon as P
from hotproofs_tpu_torch.tools import field_mul as FM
from hotproofs_tpu_torch.tools import msm_designs as D
from hotproofs_tpu_torch.tools import wsum_affine as WA

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "hotproofs_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top.startswith("hotproofs_tpu") \
        and top != "hotproofs_tpu_torch"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_reference(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_foreign(n) for n in names), \
            f"{path.relative_to(REPO)}:{node.lineno} imports {names}"


_IMPORTS = r"""
import sys
import hotproofs_tpu_torch.models.chunk_prover
import hotproofs_tpu_torch.tools.msm_designs
import hotproofs_tpu_torch.tools.field_mul
import hotproofs_tpu_torch.tools.wsum_affine
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib")
             or (m.startswith("hotproofs_tpu")
                 and not m.startswith("hotproofs_tpu_torch")))
assert not bad, bad
print("PORT ALONE OK")
"""


def test_entry_points_load_nothing_of_the_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _IMPORTS], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT ALONE OK" in res.stdout


def test_blake3_copies_match_the_reference():
    for data, hexd in ((b"abc", "6437b3ac3846"), (bytes(68), "155e0c74d6aa"),
                       (bytes(1028), "3c94b113d1a2")):
        assert b3.hash_hex(data).startswith(hexd)
        assert b3.hash_bytes(data) == R_b3.hash_bytes(data)
    data = np.random.default_rng(0).bytes(5 * 1024 + 77)
    assert native.get_lib() is not None
    assert native._SO != R_native._SO and native._SRC != R_native._SRC
    assert native.hash_bytes(data) == R_native.hash_bytes(data) \
        == R_b3.hash_bytes(data)
    for ci in (0, 3, 5):
        got = native.hash_with_path(data, ci)
        want = R_b3.hash_with_path(data, ci)
        assert (got.root_hash, got.total_depth, got.leaf_depth,
                got.chunk_bytes) == (want.root_hash, want.total_depth,
                                     want.leaf_depth, want.chunk_bytes)
        assert [(n.down_left, n.sibling_cv) for n in got.parent_path] == \
            [(n.down_left, n.sibling_cv) for n in want.parent_path]


def test_native_sponge_and_fold_point_match_the_reference():
    assert native_ff.available() and R_native_ff.available()
    assert native_ff._SO != R_native_ff._SO
    spec = P.spec_for(C.PALLAS.scalar.name)
    rng = np.random.default_rng(1)
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(11)]
    ours = native_ff.NativeSponge(spec, domain_tag=5)
    ref = R_native_ff.NativeSponge(spec, domain_tag=5)
    for s in (ours, ref):
        s.absorb(vals)
    assert ours.squeeze() == ref.squeeze()
    assert ours.state == ref.state
    pts = [C.host_scalar_mul(C.PALLAS, k, C.PALLAS.gen) for k in (3, 7)]
    for acc, q in ((None, pts[0]), (pts[0], pts[1]), (pts[1], None)):
        r = int.from_bytes(rng.bytes(32), "little")
        assert native_ff.fold_point(C.PALLAS, acc, q, r) == \
            R_native_ff.fold_point(C.PALLAS, acc, q, r)
    tr = Transcript(C.PALLAS.scalar.name, b"boundary", 99)
    assert isinstance(tr.sponge, native_ff.NativeSponge)


def _r1cs_digest(r1cs) -> str:
    h = hashlib.sha256(repr((r1cs.modulus, r1cs.n_signals,
                             r1cs.n_constraints, r1cs.n_io)).encode())
    for rows, cols, vals in (r1cs.A, r1cs.B, r1cs.C):
        h.update(rows.tobytes() + cols.tobytes()
                 + repr([int(v) for v in vals]).encode())
    return h.hexdigest()


def test_blake3_nova_circuit_matches_the_reference():
    p = C.PALLAS.scalar.p
    ours, layout = nova.get_nova_step_circuit(p, 0, 8)
    ref, ref_layout = R_nova.get_nova_step_circuit(p, 0, 8)
    assert (ours.n_constraints, ours.n_signals, ours.n_io) == \
        (ref.n_constraints, ref.n_signals, ref.n_io) == (16162, 15953, 30)
    assert [len(m[0]) for m in (ours.A, ours.B, ours.C)] == \
        [16189, 24000, 46182]
    assert _r1cs_digest(ours) == _r1cs_digest(ref)
    assert [(s.name, s.start, s.length, s.role) for s in layout.segments] \
        == [(s.name, s.start, s.length, s.role)
            for s in ref_layout.segments]


def test_entry_points_default_to_the_card(capsys):
    for argv in (["prove", "--help"], ["verify", "--help"]):
        with pytest.raises(SystemExit) as e:
            CP.main(argv)
        assert e.value.code == 0
        assert "default: cuda" in capsys.readouterr().out
    for tool in (D, FM, WA):
        with pytest.raises(SystemExit):
            tool.main(["--help"])
        assert "default: cuda" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot show")
    for make in (CP.ChunkProver, lambda: D.main([]), lambda: FM.main([]),
                 lambda: WA.main([]),
                 lambda: CP.main(["verify", "--proof", "x"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
