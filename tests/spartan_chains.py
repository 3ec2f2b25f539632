"""The two step circuits of the Spartan fixtures
(tests/data/torch_{toy,wide}_spartan_ref.json.gz) and the port's stack over
them: tests/test_torch_spartan.py (which also makes the fixtures with the
JAX package), tests/test_torch_cuda_chunk.py and chip_smoke.py's
compression phase share them. Imports no JAX."""

import gzip
import json
import os

import numpy as np
import torch

from hotproofs_tpu_torch.circuits import gadgets as g
from hotproofs_tpu_torch.circuits.blake3_compression import VESTA_PRIME
from hotproofs_tpu_torch.circuits.dsl import compile_circuit
from hotproofs_tpu_torch.nova import spartan as SP
from hotproofs_tpu_torch.nova.ivc import IVC
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.nova.r1cs import ShapeDevice
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
P = VESTA_PRIME
CONST = 7
WIDE_PRODUCTS = 60
CHAINS = {"toy": (b"toy-spartan", 5, 4), "wide": (b"wide-spartan", 5, 3)}


def toy_step(ctx, gadgets=g):
    z_out = ctx.declare_output("z_out", 1)
    z_in = ctx.declare_input("z_in", 1, public=True)
    sq = gadgets.mul(ctx, z_in[0], z_in[0], name="sq")
    cube = gadgets.mul(ctx, sq, z_in[0], name="cube")
    ctx.bind(z_out[0], cube + CONST)


def wide_step(ctx, gadgets=g):
    z_out = ctx.declare_output("z_out", 1)
    z_in = ctx.declare_input("z_in", 1, public=True)
    x = z_in[0]
    for i in range(WIDE_PRODUCTS):
        x = gadgets.mul(ctx, x, x + (i + 1), name=f"m{i}")
    ctx.bind(z_out[0], x + CONST)


STEPS = {"toy": toy_step, "wide": wide_step}


def key_size(shape) -> int:
    """The power of two >= max(n_wit, n_cons, n_vars): Spartan's L
    opening needs next_pow2(n_vars) generators."""
    return SP._next_pow2(max(shape.n_wit, shape.n_cons, shape.n_vars))


def ref_path(name: str) -> str:
    return os.path.join(DATA, f"torch_{name}_spartan_ref.json.gz")


def load_ref(name: str) -> dict:
    with gzip.open(ref_path(name), "rt") as f:
        return json.load(f)


def port_stack(name: str, curve=C.PALLAS, label=None, device="cpu"):
    """(IVC, SpartanSystem, layout) of the port on device; the key's
    generators are derived in memory."""
    r1cs, layout = compile_circuit(STEPS[name], curve.scalar.p)
    shape = ShapeDevice.from_dsl(r1cs, device)
    ck = small_key(curve, label or CHAINS[name][0], key_size(shape), device)
    ivc = IVC(shape, curve, ck, None)
    return ivc, SP.SpartanSystem(ivc), layout


# ---------------------------------------------------------------------------
# One strict step instance taken as relaxed: u = 1, E = 0 and comm_E the
# identity, as the compressed recursive proof's third claim has it
# (tests/data/torch_{name}_spartan_strict_ref.json.gz).
# ---------------------------------------------------------------------------


def strict_path(name: str) -> str:
    return os.path.join(DATA, f"torch_{name}_spartan_strict_ref.json.gz")


def load_strict_ref(name: str) -> dict:
    with gzip.open(strict_path(name), "rt") as f:
        return json.load(f)


def _commit_host(C_, curve, gens_mont, W):
    """sum W_i G_i on the host (ops.curve of either package); gens_mont the
    key's (n, 2, 32) Montgomery affine digits."""
    f = curve.base
    rinv = pow(f.r_mod_p, f.p - 2, f.p)
    gens = [tuple(int.from_bytes(np.asarray(c, np.uint8).tobytes(), "little")
                  * rinv % f.p for c in g) for g in gens_mont[:len(W)]]
    return C_.host_msm(curve, W, gens)


def strict_claim(name: str, ivc, layout):
    """(instance, W, E) of the port for chain `name`'s first step (z_in =
    z0 of CHAINS) over the port stack's ivc: the witness after (1, X), its
    commitment on the host, E all zero."""
    from hotproofs_tpu_torch.circuits.dsl import eval_witness
    from hotproofs_tpu_torch.nova.fold import AccumulatorInstance
    z0 = CHAINS[name][1]
    w = eval_witness(lambda ctx: STEPS[name](ctx, g), layout,
                     {"z_in": [z0]})
    n_io = ivc.shape.n_io
    W = [int(v) % P for v in w[1 + n_io:]]
    inst = AccumulatorInstance(
        u=1, X=[int(v) % P for v in w[1:1 + n_io]],
        comm_W=_commit_host(C, ivc.curve, ivc.ck.gens_affine, W),
        comm_E=None)
    return inst, W, [0] * ivc.shape.n_cons


def make_strict_reference(name: str) -> dict:
    """The JAX package's Spartan argument (prove_relaxed, then
    verify_relaxed) for chain `name`'s first step instance, strict and
    taken as relaxed, on a bare SpartanSystem over the chain's key and
    pp digest; the instance as the fixture stores it beside the proof."""
    import jax

    from hotproofs_tpu.circuits import gadgets as rg
    from hotproofs_tpu.circuits.dsl import compile_circuit as r_compile
    from hotproofs_tpu.circuits.dsl import eval_witness as r_eval
    from hotproofs_tpu.nova import serial as r_serial
    from hotproofs_tpu.nova.fold import AccumulatorInstance as RInst
    from hotproofs_tpu.nova.ivc import IVC as RIVC
    from hotproofs_tpu.nova.pedersen import CommitmentKey as RCK
    from hotproofs_tpu.nova.r1cs import ShapeDevice as RShape
    from hotproofs_tpu.nova.spartan import SpartanSystem as RSpartan
    from hotproofs_tpu.ops import curve as RC

    label, z0, _ = CHAINS[name]
    step = lambda ctx: STEPS[name](ctx, rg)
    r1cs, layout = r_compile(step, P)
    shape = RShape.from_dsl(r1cs)
    ivc = RIVC(shape, RC.PALLAS, RCK.create(RC.PALLAS, label,
                                            key_size(shape)), None)
    w = r_eval(step, layout, {"z_in": [z0]})
    n_io = shape.n_io
    W = [int(v) % P for v in w[1 + n_io:]]
    inst = RInst(u=1, X=[int(v) % P for v in w[1:1 + n_io]],
                 comm_W=_commit_host(RC, RC.PALLAS, ivc.ck.gens_affine, W),
                 comm_E=None)
    sps = RSpartan(shape=shape, curve=RC.PALLAS, ck=ivc.ck,
                   pp_digest=ivc.pp_digest)
    sp = sps.prove_relaxed(inst, W, [0] * shape.n_cons)
    jax.clear_caches()
    sps.verify_relaxed(inst, sp)
    return {"instance": {"u": 1, "x": r_serial.enc_ints(inst.X),
                         "cw": r_serial.enc_point(inst.comm_W),
                         "ce": r_serial.enc_point(None)},
            "pp_digest": int(ivc.pp_digest),
            "spartan": sp.to_dict()}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/spartan_chains.py
    #     strict wide OUT.json.gz
    # (the reference's XLA compiles: about 20 minutes on an 8-core CPU)
    import sys
    doc = make_strict_reference(sys.argv[2])
    with gzip.open(sys.argv[3], "wt") as f:
        json.dump(doc, f)


def host_tables(shape, ck, m: int):
    """The matrix tables by the host loop the reference builds them with
    (hotproofs_tpu/nova/spartan.py:427-493): one native fold_point a
    nonzero (host_add / host_scalar_mul without the native helper), as
    host (x, y, inf) arrays of Montgomery digits; the oracle of the
    h_tables kernel and its plain version."""
    from hotproofs_tpu_torch.core import native_ff
    fs, cv = shape.field, ck.spec
    fb = cv.base
    rinv_s = pow(fs.r_mod_p, fs.p - 2, fs.p)
    rinv_b = pow(fb.r_mod_p, fb.p - 2, fb.p)
    g = ck.gens_affine[: shape.n_vars]
    gens = [(int(x) * rinv_b % fb.p, int(y) * rinv_b % fb.p)
            for x, y in zip(fb.limbs_to_ints(g[:, 0]),
                            fb.limbs_to_ints(g[:, 1]))]
    use_native = native_ff.available()
    xs = np.zeros((3, m, F.N_LIMBS), np.uint8)
    ys = np.zeros((3, m, F.N_LIMBS), np.uint8)
    inf = np.ones((3, m), bool)
    for mi, mat in enumerate((shape.A, shape.B, shape.C)):
        H: dict = {}
        vals = fs.limbs_to_ints(mat.vals_mont)
        for k in range(len(mat.rows)):
            r_, c_ = int(mat.rows[k]), int(mat.cols[k])
            v_ = int(vals[k]) * rinv_s % fs.p
            if use_native:
                H[r_] = native_ff.fold_point(cv, H.get(r_), gens[c_], v_)
            else:
                H[r_] = C.host_add(cv, H.get(r_),
                                   C.host_scalar_mul(cv, v_, gens[c_]))
        for r_, pt in H.items():
            if pt is None:
                continue
            inf[mi, r_] = False
            xs[mi, r_] = F.int_to_limbs(fb.to_mont_int(pt[0]))
            ys[mi, r_] = F.int_to_limbs(fb.to_mont_int(pt[1]))
    return xs, ys, inf


def sub_shape(shape, rows, n_cols=None, device="cpu"):
    """The rows `rows` (ascending) of shape's three matrices as a shape of
    their own, rows and columns renumbered in order (the columns then
    taken mod n_cols, if given, so that a small key serves): ->
    (ShapeDevice, the original columns it keeps). Values stay as they are,
    full-width ones and negatives included."""
    from hotproofs_tpu_torch.nova.r1cs import ShapeDevice, SparseMat
    rows = np.asarray(rows, np.int64)
    mats = [getattr(shape, k) for k in ("A", "B", "C")]
    keep = [np.isin(mat.rows, rows) for mat in mats]
    used = np.unique(np.concatenate([mat.cols[k]
                                     for mat, k in zip(mats, keep)]))
    n = len(used) if n_cols is None else min(n_cols, len(used))
    sub = [SparseMat(np.searchsorted(rows, mat.rows[k]).astype(np.int32),
                     (np.searchsorted(used, mat.cols[k]) % n).astype(
                         np.int32), mat.vals_mont[k], len(rows))
           for mat, k in zip(mats, keep)]
    return ShapeDevice(shape.field, len(rows), n, 0, *sub,
                       device=device), used


def small_key(curve, label: bytes, n: int, device="cpu"):
    """A CommitmentKey of n generators derived in memory (no disk cache)."""
    f = curve.base
    gens = np.asarray([[F.int_to_limbs(f.to_mont_int(x)),
                        F.int_to_limbs(f.to_mont_int(y))]
                       for x, y in C.derive_generators(curve, label, n)],
                      np.int32)
    return CommitmentKey(curve, n, gens, label, torch.device(device))


def table_test_rows(shape, n_full: int, seed: int = 0, head: int = 16,
                    longest: bool = True):
    """Rows for a tables check: the first `head`, the longest row of each
    matrix (if `longest`), and n_full rows drawn (seeded) among those
    holding a value whose min(v, p - v) is over 192 bits."""
    from hotproofs_tpu_torch.ops import tables as TB
    m = shape.n_cons
    csr = TB.table_csr(shape.field, [
        (d.rows, d.cols, d.vals) for d in (shape.dev[k]
                                           for k in ("A", "B", "C"))], m)
    rp = csr.row_ptr.to(torch.int64).cpu()
    row = torch.repeat_interleave(torch.arange(3 * m), rp[1:] - rp[:-1])
    full = (csr.mag[:, 6:] != 0).any(-1).cpu()
    cand = torch.unique(row[full] % m).numpy()
    long_rows = [int(np.argmax(np.bincount(getattr(shape, k).rows)))
                 for k in ("A", "B", "C")] if longest else []
    pick = np.random.default_rng(seed).choice(cand, n_full, replace=False)
    return sorted(set(range(head)) | set(long_rows)
                  | {int(r) for r in pick})
