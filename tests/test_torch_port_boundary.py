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

from hotproofs_tpu.circuits import bignat_gadget as R_BN
from hotproofs_tpu.circuits import blake3_nova as R_nova
from hotproofs_tpu.circuits import ec_gadget as R_EC
from hotproofs_tpu.circuits import gadgets as R_g
from hotproofs_tpu.circuits import nova_augmented as R_NA
from hotproofs_tpu.circuits import poseidon_gadget as R_PG
from hotproofs_tpu.circuits import dsl as R_dsl
from hotproofs_tpu.ops import poseidon as R_P
from hotproofs_tpu.core import blake3_ref as R_b3
from hotproofs_tpu.core import circom_artifacts as R_CA
from hotproofs_tpu.core import native as R_native
from hotproofs_tpu.core import native_ff as R_native_ff
from hotproofs_tpu_torch.circuits import bignat_gadget as BN
from hotproofs_tpu_torch.circuits import blake3_nova as nova
from hotproofs_tpu_torch.circuits import dsl
from hotproofs_tpu_torch.circuits import ec_gadget as EC
from hotproofs_tpu_torch.circuits import gadgets as g
from hotproofs_tpu_torch.circuits import nova_augmented as NA
from hotproofs_tpu_torch.circuits import poseidon_gadget as PG
from hotproofs_tpu_torch.core import blake3_ref as b3
from hotproofs_tpu_torch.core import circom_artifacts as CA
from hotproofs_tpu_torch.core import native, native_ff
from hotproofs_tpu_torch.models import chunk_prover as CP
from hotproofs_tpu_torch.nova.transcript import Transcript
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import poseidon as P
from hotproofs_tpu_torch.tools import field_mul as FM
from hotproofs_tpu_torch.tools import msm_designs as D
from hotproofs_tpu_torch.tools import trace_check as TC
from hotproofs_tpu_torch.tools import wsum_affine as WA

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "hotproofs_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
# The recursive SNARK's modules and their circuits (the port's copies).
RECURSIVE_FILES = [REPO / "hotproofs_tpu_torch" / f for f in (
    "circuits/bignat_gadget.py", "circuits/ec_gadget.py",
    "circuits/poseidon_gadget.py", "circuits/nova_augmented.py",
    "nova/recursive.py")]
# The last modules ported: the circom parsers (a copy), the batched
# Poseidon permutation and the telemetry with its capture.
LAST_FILES = [REPO / "hotproofs_tpu_torch" / f for f in (
    "core/circom_artifacts.py", "ops/poseidon.py", "utils/telemetry.py")]


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


def test_the_recursive_modules_are_checked():
    assert all(f in PORT_FILES for f in RECURSIVE_FILES)


def test_the_last_modules_are_checked():
    assert all(f in PORT_FILES for f in LAST_FILES)


def test_circom_artifacts_is_the_reference_copied_unchanged():
    """The parsers are jax-free, so the port keeps them as they are: the
    same source, and the same objects from the same bytes."""
    ours = REPO / "hotproofs_tpu_torch" / "core" / "circom_artifacts.py"
    ref = REPO / "hotproofs_tpu" / "core" / "circom_artifacts.py"
    assert ours.read_bytes() == ref.read_bytes()
    assert CA.__file__ != R_CA.__file__
    assert CA.parse_sym is not R_CA.parse_sym


_IMPORTS = r"""
import sys
import hotproofs_tpu_torch.models.chunk_prover
import hotproofs_tpu_torch.nova.recursive
import hotproofs_tpu_torch.tools.msm_designs
import hotproofs_tpu_torch.tools.field_mul
import hotproofs_tpu_torch.tools.wsum_affine
import hotproofs_tpu_torch.core.circom_artifacts
import hotproofs_tpu_torch.ops.poseidon
import hotproofs_tpu_torch.utils.telemetry
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


# Small circuits over each of the four circuit copies the recursive SNARK
# adds, built once with the port's modules and once with the reference's:
# (circuit, its field, its inputs) from (gadgets, copy, poseidon) modules.
def _bignat_case(gm, BNm, Pm):
    q, m = C.PALLAS.scalar.p, C.VESTA.scalar.p
    rng = np.random.default_rng(21)
    a, b = (int.from_bytes(rng.bytes(32), "little") % m for _ in range(2))

    def circ(ctx):
        out = ctx.declare_output("out", 2 * BNm.N_LIMBS)
        an = BNm.BigNat(list(ctx.declare_input("a", BNm.N_LIMBS, False)))
        bn = BNm.BigNat(list(ctx.declare_input("b", BNm.N_LIMBS, False)))
        BNm.assert_less_than_m(ctx, an, m)
        r = BNm.mul_mod(ctx, m, an, bn)
        s_ = BNm.add_mod(ctx, m, r, bn)
        for o, v in zip(out, r.limbs + s_.limbs):
            ctx.bind(o, v)

    return circ, q, {"a": BNm.limbs_of_int(a), "b": BNm.limbs_of_int(b)}


def _ec_case(gm, ECm, Pm):
    spec = C.PALLAS
    p, b3 = spec.base.p, 3 * spec.b % spec.base.p
    (x1, y1), (x2, y2) = C.derive_generators(spec, b"boundary-ec", 2)
    k = int.from_bytes(np.random.default_rng(22).bytes(8), "little")

    def circ(ctx):
        out = ctx.declare_output("out", 9)
        a = ctx.declare_input("a", 2, public=False)
        b = ctx.declare_input("b", 2, public=False)
        kk = ctx.declare_input("k", 1, public=False)
        pa, pb = (a[0], a[1], 1), (b[0], b[1], 1)
        s_ = ECm.add(ctx, b3, pa, pb)
        d = ECm.double(ctx, b3, s_)
        km = ECm.scalar_mul(ctx, b3, gm.tobits(ctx, kk[0], 64, name="kb"),
                            pb)
        ECm.assert_on_curve(ctx, spec.b, pa)
        for o, v in zip(out, list(s_) + list(d) + list(km)):
            ctx.bind(o, v)

    return circ, p, {"a": [x1, y1], "b": [x2, y2], "k": [k]}


def _poseidon_case(gm, PGm, Pm):
    q = C.PALLAS.scalar.p
    spec = Pm.make_spec(C.PALLAS.scalar.name)
    vals = [int.from_bytes(np.random.default_rng(23 + i).bytes(32),
                           "little") % q for i in range(5)]

    def circ(ctx):
        out = ctx.declare_output("out", 2)
        x = ctx.declare_input("x", 5, public=False)
        sp = PGm.SpongeGadget(ctx, spec, 7)
        sp.absorb(list(x))
        h1 = sp.squeeze()
        sp.absorb([h1, x[0]])
        ctx.bind(out[0], h1)
        ctx.bind(out[1], sp.squeeze())

    return circ, q, {"x": vals}


def _augmented_case(gm, NAm, Pm):
    """The secondary augmented circuit (Pallas instances folded over F_p)
    at its base step: k_prev = 0, default instances, no T."""
    cur1, cur2 = C.PALLAS, C.VESTA
    p, q = cur2.scalar.p, cur1.scalar.p
    vk = int.from_bytes(np.random.default_rng(24).bytes(31), "little")
    circ = NAm.make_augmented_circuit(Pm.make_spec(cur2.scalar.name),
                                      cur1.b, q, vk, 0, None,
                                      fold_at_base=False)
    zero = [0] * BN.N_LIMBS
    inputs = {"k_prev": [0], "U_cw": [0, 0, 1], "U_ce": [0, 0, 1],
              "U_u": zero, "U_x0": zero, "U_x1": zero, "u_cw": [0, 0, 1],
              "u_x0": zero, "u_x1": zero, "T_cw": [0, 0, 1]}
    return circ, p, inputs


@pytest.mark.parametrize("case,ours,ref", [
    (_bignat_case, (g, BN, P), (R_g, R_BN, R_P)),
    (_ec_case, (g, EC, P), (R_g, R_EC, R_P)),
    (_poseidon_case, (g, PG, P), (R_g, R_PG, R_P)),
    (_augmented_case, (g, NA, P), (R_g, R_NA, R_P)),
], ids=["bignat_gadget", "ec_gadget", "poseidon_gadget", "nova_augmented"])
def test_recursive_circuit_copies_match_the_reference(case, ours, ref):
    """Each circuit copy compiles to the reference's R1CS and evaluates to
    the reference's witness on seeded inputs."""
    circ, mod, inputs = case(*ours)
    r_circ, r_mod, r_inputs = case(*ref)
    r1cs, layout = dsl.compile_circuit(circ, mod)
    r_r1cs, r_layout = R_dsl.compile_circuit(r_circ, r_mod)
    assert _r1cs_digest(r1cs) == _r1cs_digest(r_r1cs)
    w = dsl.eval_witness(circ, layout, inputs)
    r_w = R_dsl.eval_witness(r_circ, r_layout, r_inputs)
    assert [int(v) for v in w] == [int(v) for v in r_w]
    assert r1cs.n_constraints > 0 and len(w) == r1cs.n_signals


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
                 lambda: WA.main([]), TC.main,
                 lambda: CP.main(["verify", "--proof", "x"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
