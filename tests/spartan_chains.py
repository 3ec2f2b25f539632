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
    n = key_size(shape)
    label = label or CHAINS[name][0]
    f = curve.base
    gens = np.asarray([[F.int_to_limbs(f.to_mont_int(x)),
                        F.int_to_limbs(f.to_mont_int(y))]
                       for x, y in C.derive_generators(curve, label, n)],
                      np.int32)
    ivc = IVC(shape, curve, CommitmentKey(curve, n, gens, label,
                                          torch.device(device)), None)
    return ivc, SP.SpartanSystem(ivc), layout
