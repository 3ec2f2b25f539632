"""Name parity between the JAX package and its port, read with ast (neither
package is imported).

For every module of hotproofs_tpu/, each public top-level name (function,
class, constant) and each public method of its classes must have one of:
  * the same name in the port's module of the same path;
  * an entry in ALIASES: the JAX name -> the port's name for it (a path
    `module.name` or `module.Class.method`), with a note where the two
    differ in more than the name;
  * an entry in TPU_ONLY: a piece that exists for the TPU or for XLA, with
    a one-line reason and the port's counterpart (a module name or a file
    under hotproofs_tpu_torch/).
A name in none of them fails the test, so a gap cannot come back unseen.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
REF = REPO / "hotproofs_tpu"
PORT = REPO / "hotproofs_tpu_torch"

# JAX module path (without .py) -> the port's module path.
MODULES = {
    "circuits/witness_jax": "circuits/witness_torch",
}

# "module.name" of the JAX package -> ("module.name" in the port, note).
ALIASES = {
    "ops/field.inv_mont": ("ops/field.inv", ""),
    "ops/curve.identity_for": ("ops/curve.identity", ""),
    "circuits/witness_jax.U32": (
        "circuits/witness_torch.MASK32",
        "u32 words held in int64 and masked to 32 bits"),
    "circuits/witness_jax.batched_compression_witness": (
        "circuits/witness_torch.batched_nova_witness",
        "the compression's witness is the first part of a step's"),
    "circuits/witness_jax.jitted_generator": (
        "circuits/witness_torch.batched_nova_witness", "torch runs eagerly"),
    "circuits/witness_jax.jitted_nova_generator": (
        "circuits/witness_torch.batched_nova_witness", "torch runs eagerly"),
    "circuits/witness_jax.expected_n_signals": (
        "circuits/blake3_compression.get_compression_circuit",
        "the n_signals of its R1CS"),
    "ops/msm.msm": (
        "ops/msm_pallas.msm_many", "over scale16-prepared bases"),
    "ops/msm.msm_jitted": ("ops/msm_pallas.msm_many", "torch runs eagerly"),
    "ops/msm.n_windows4": ("ops/msm_pallas.n_windows4", ""),
    "ops/msm.scale_points16": ("ops/msm_pallas.scale_points16", ""),
    "ops/msm.RADIX_BITS": ("ops/msm_pallas.RADIX_BITS", ""),
    "ops/msm.N_BUCKETS": ("ops/msm_pallas.NBUCKET", "digit values 1..15"),
    "ops/msm_pallas.msm_pallas": (
        "ops/msm_pallas.msm_many", "one job of the batched MSM"),
    "ops/msm_pallas.msm_pallas_many": ("ops/msm_pallas.msm_many", ""),
    "ops/msm_pallas.batch_inv_mont_lm": (
        "ops/msm_pallas.to_affine", "the inversion runs inside it"),
    "ops/msm_pallas.scaled_affine_device": (
        "nova/pedersen.CommitmentKey.scaled_affine", ""),
    "ops/msm_pallas.to_tm": ("ops/msm_pallas.bases_tm", ""),
    "ops/msm_pallas.L": ("ops/pallas_field.L", "digits per element"),
    "ops/msm_pallas.NSLOT": ("ops/msm_pallas.NBUCKET", "slot 0 unused"),
    "ops/msm_pallas.LB": ("ops/msm_pallas.BUCKET_LANES", "lanes a block"),
    "ops/msm_pallas.BC": ("ops/msm_pallas.plan", "steps a lane"),
    "ops/pallas_field.mont_mul_rows": ("ops/pallas_field.mont_mul_lm", ""),
    "ops/pallas_field.field_consts": (
        "ops/pallas_field.field_consts_words", ""),
    "ops/pallas_field.field_consts_dev": ("ops/pallas_field.consts_arg", ""),
    "ops/pallas_field.add_rows": ("ops/field.add", ""),
    "ops/pallas_field.sub_rows": ("ops/field.sub", ""),
    "nova/r1cs.to_mont_vec": ("ops/field.to_mont", ""),
    "nova/r1cs.witness_to_device": ("ops/field.from_ints", ""),
    "nova/pedersen.CommitmentKey.scaled": (
        "nova/pedersen.CommitmentKey.scaled_affine", "affine bases"),
    "nova/pedersen.CommitmentKey.scaled_tm": (
        "nova/pedersen.CommitmentKey.bases", ""),
    "nova/pedersen.CommitmentKey.scaled_big": (
        "nova/pedersen.CommitmentKey.bases_big", ""),
    "nova/pedersen.CommitmentKey.scaled_tm_big": (
        "nova/pedersen.CommitmentKey.bases_big_lm", ""),
    "nova/pedersen.CommitmentKey.commit_pallas": (
        "nova/pedersen.CommitmentKey.commit", ""),
    "nova/pedersen.CommitmentKey.commit_fn": (
        "nova/pedersen.CommitmentKey.commit", "torch runs eagerly"),
    "nova/pedersen.CommitmentKey.commit_pallas_fn": (
        "nova/pedersen.CommitmentKey.commit", "torch runs eagerly"),
    "nova/pedersen.CommitmentKey.commit_many_pallas": (
        "nova/pedersen.CommitmentKey.commit_many", ""),
    "nova/pedersen.CommitmentKey.commit_many_pallas_fn": (
        "nova/pedersen.CommitmentKey.commit_many", "torch runs eagerly"),
    "nova/pedersen.CommitmentKey.commit_many_pallas_mesh": (
        "nova/pedersen.CommitmentKey.commit_many_mesh", ""),
    "nova/pedersen.CommitmentKey.commit_split": (
        "nova/pedersen.CommitmentKey.commit_many_split", "J = 1"),
    "nova/pedersen.CommitmentKey.commit_split_fn": (
        "nova/pedersen.CommitmentKey.commit_many_split",
        "torch runs eagerly"),
    "nova/pedersen.CommitmentKey.commit_split_pallas": (
        "nova/pedersen.CommitmentKey.commit_many_split", "J = 1"),
    "nova/pedersen.CommitmentKey.commit_split_pallas_fn": (
        "nova/pedersen.CommitmentKey.commit_many_split",
        "torch runs eagerly"),
    "nova/pedersen.CommitmentKey.commit_many_split_pallas": (
        "nova/pedersen.CommitmentKey.commit_many_split", ""),
    "nova/pedersen.CommitmentKey.commit_many_split_pallas_fn": (
        "nova/pedersen.CommitmentKey.commit_many_split",
        "torch runs eagerly"),
}

# "module.name" of the JAX package -> (reason, the port's counterpart).
TPU_ONLY = {
    "utils/config.setup_jax": (
        "JAX's platform and compile-cache settings", "utils/config"),
    "utils/config.pallas_msm_enabled": (
        "chooses the Pallas MSM or XLA's; the port has one MSM",
        "ops/msm_pallas"),
    "ops/field.jitted": ("jit caches of the XLA field ops", "ops/field"),
    "ops/msm.DUMP": ("the XLA MSM's dump bucket", "ops/msm_pallas"),
    "ops/msm.msm_scan": (
        "an XLA MSM for XLA:CPU's compile limits", "csrc/msm.cu"),
    "ops/msm.use_scan_msm": ("picks msm_scan", "csrc/msm.cu"),
    "ops/pallas_field.interpret": (
        "Pallas interpret mode on the CPU; the port's wrappers take their "
        "plain versions there", "ops/pallas_field"),
    "ops/pallas_field.N_LANES": ("the TPU's lane width", "csrc/mont.cu"),
    "ops/pallas_field.toeplitz_of": (
        "the MXU Toeplitz pack of the product", "csrc/conv_mma.cuh"),
    "ops/pallas_field.toep_consts": (
        "the MXU Toeplitz packs of p and mu", "csrc/conv_mma.cuh"),
    "ops/pallas_field.toep_consts_dev": (
        "the MXU Toeplitz packs on the device", "csrc/conv_mma.cuh"),
    "ops/pallas_field.mont_mul_toep_rows": (
        "the product on the MXU", "csrc/conv_mma.cu"),
}
# ops/pallas_curve.py (the Pallas point formulas on limb rows, their
# constants and Toeplitz packs): csrc/curve.cuh in the kernels, and
# ops/curve.py's plain torch formulas.
for _name in ("L", "curve_consts", "curve_consts_dev", "curve_toep",
              "curve_toep_dev", "identity_rows", "pt_add_mixed_rows",
              "pt_add_rows", "pt_double_rows", "pt_neg_rows",
              "pt_select_rows"):
    TPU_ONLY["ops/pallas_curve." + _name] = (
        "Pallas point formulas on limb rows", "csrc/curve.cuh")


def public_names(path: pathlib.Path) -> set:
    """Public top-level functions, classes and assigned names, and the
    public methods of the classes as `Class.method`."""
    out = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and not m.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out.update(e.id for t in targets for e in ast.walk(t)
                       if isinstance(e, ast.Name)
                       and not e.id.startswith("_"))
    return out


def _mod(rel: str) -> str:
    return rel[:-3] if rel.endswith(".py") else rel


REF_MODULES = sorted(_mod(str(p.relative_to(REF)))
                     for p in REF.rglob("*.py"))


def _port_names(module: str) -> set:
    path = PORT / (module + ".py")
    return public_names(path) if path.exists() else set()


def _port_has(target: str) -> bool:
    """`module.name` (or `module.Class.method`) exists in the port."""
    module, name = target.split(".", 1)
    return name in _port_names(module)


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port_module = MODULES.get(module, module)
    here = _port_names(port_module)
    missing = []
    for name in sorted(public_names(REF / (module + ".py"))):
        key = f"{module}.{name}"
        if name in here or key in ALIASES or key in TPU_ONLY:
            continue
        missing.append(key)
    assert not missing, (
        f"public names of hotproofs_tpu/{module}.py with no counterpart in "
        f"hotproofs_tpu_torch/{port_module}.py, no alias and no TPU-only "
        f"entry: {missing}")


def test_aliases_and_tpu_only_entries_name_what_exists():
    ref = {f"{m}.{n}" for m in REF_MODULES
           for n in public_names(REF / (m + ".py"))}
    for key, (target, _) in ALIASES.items():
        assert key in ref, f"alias of a name the reference lacks: {key}"
        assert _port_has(target), f"{key} -> {target}: not in the port"
    for key, (reason, counterpart) in TPU_ONLY.items():
        assert key in ref, f"TPU-only entry the reference lacks: {key}"
        assert reason and not ALIASES.get(key)
        assert (PORT / counterpart).is_file() or \
            (PORT / (counterpart + ".py")).is_file(), counterpart
    for module, port_module in MODULES.items():
        assert (REF / (module + ".py")).is_file()
        assert (PORT / (port_module + ".py")).is_file()


def test_every_reference_module_has_a_port_module():
    """Each module of the JAX package has a module of the same path in the
    port, or one named in MODULES, or is TPU-only (every public name
    listed), or is XLA's MSM, whose names all alias the port's MSM."""
    for module in REF_MODULES:
        port_module = MODULES.get(module, module)
        if (PORT / (port_module + ".py")).is_file():
            continue
        names = public_names(REF / (module + ".py"))
        assert names and all(f"{module}.{n}" in ALIASES
                             or f"{module}.{n}" in TPU_ONLY
                             for n in names), module


def test_the_checker_finds_a_gap(tmp_path):
    """public_names sees functions, classes, their methods and constants,
    and skips private names, so a dropped name would be caught."""
    src = tmp_path / "m.py"
    src.write_text("A = 1\n_B = 2\nx: int = 3\n"
                   "def f(): pass\ndef _g(): pass\n"
                   "class K:\n    def m(self): pass\n"
                   "    def _n(self): pass\n    @property\n"
                   "    def p(self): return 1\n")
    assert public_names(src) == {"A", "x", "f", "K", "K.m", "K.p"}
