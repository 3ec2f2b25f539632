"""The toy chain z -> z^3 + 7 of tests/test_ivc_toy.py, shared by the
port's IVC tests: its circuit, the b"toy" key's generators, the chain's
witnesses, and the reference fixtures made from it
(tests/data/torch_toy_proof_ref.json, made by the JAX package's IVC.prove,
and tests/data/torch_toy_checkpoint_ref.json, the checkpoint its
prove_batch(checkpoint_every=2) leaves after step 4 of the 5-step chain).
The circuit DSL is the reference's; the port side imports no JAX."""

import json
import os

import numpy as np

from hotproofs_tpu.circuits import gadgets as g
from hotproofs_tpu.circuits.blake3_compression import VESTA_PRIME
from hotproofs_tpu.circuits.dsl import compile_circuit, eval_witness

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REF_PROOF = os.path.join(DATA, "torch_toy_proof_ref.json")
REF_CHECKPOINT = os.path.join(DATA, "torch_toy_checkpoint_ref.json")
CONST = 7
P = VESTA_PRIME
# The reference checkpoint's chain: 5 steps from z0 = 3 (the proof
# fixture's), saved every 2 folds; the last save is after fold 4.
CKPT_Z0, CKPT_STEPS, CKPT_EVERY = 3, 5, 2


def toy_step(ctx):
    z_out = ctx.declare_output("z_out", 1)
    z_in = ctx.declare_input("z_in", 1, public=True)
    sq = g.mul(ctx, z_in[0], z_in[0], name="sq")
    cube = g.mul(ctx, sq, z_in[0], name="cube")
    ctx.bind(z_out[0], cube + CONST)


def toy_gens(n):
    """The b"toy" key's generators, derived in memory: the reference's
    tests/test_ivc_toy.py may be writing the shared .cache file meanwhile."""
    from hotproofs_tpu_torch.ops import curve as C
    from hotproofs_tpu_torch.ops import field as F
    f = C.PALLAS.base
    return np.asarray([[F.int_to_limbs(f.to_mont_int(x)),
                        F.int_to_limbs(f.to_mont_int(y))]
                       for x, y in C.derive_generators(C.PALLAS, b"toy", n)],
                      np.int32)


def toy_ivc(device="cpu"):
    """(the port's IVC of the toy circuit with the b"toy" key, r1cs,
    layout)."""
    import torch

    from hotproofs_tpu_torch.nova.ivc import IVC
    from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
    from hotproofs_tpu_torch.nova.r1cs import ShapeDevice
    from hotproofs_tpu_torch.ops import curve as C
    r1cs, layout = compile_circuit(toy_step, P)
    shape = ShapeDevice.from_dsl(r1cs, device)
    n = max(shape.n_wit, shape.n_cons)
    ck = CommitmentKey(C.PALLAS, n, toy_gens(n), b"toy",
                       torch.device(device))
    return IVC(shape, C.PALLAS, ck, None), r1cs, layout


def witnesses(layout, z0, n_steps):
    """The chain's full DSL witness vectors (object ints) and z_final."""
    z, wits = z0 % P, []
    for _ in range(n_steps):
        wits.append(eval_witness(toy_step, layout, {"z_in": [z]}))
        z = (pow(z, 3, P) + CONST) % P
    return wits, z


def chain(layout, z0, n_steps):
    """(canon (N, n_vars, 32), X_host, z_final) of a toy chain."""
    from hotproofs_tpu_torch.ops import field as F
    wits, z = witnesses(layout, z0, n_steps)
    spec = F.pallas_scalar
    canon = np.stack([spec.batch_to_limbs([int(v) for v in w])
                      for w in wits])
    X = [[int(v) % P for v in w[1:3]] for w in wits]
    return canon, X, z


def ref_dict():
    with open(REF_PROOF) as f:
        return json.load(f)


def make_reference_checkpoint(path: str) -> dict:
    """The JAX package's prove_batch of the checkpoint chain with
    checkpoint_every=CKPT_EVERY, writing its checkpoints to path; returns
    its proof's dict (the proof fixture's bytes). XLA:CPU compiles its
    fold and MSM programs for minutes."""
    import jax.numpy as jnp
    from hotproofs_tpu.nova.ivc import IVC as RIVC
    from hotproofs_tpu.nova.pedersen import CommitmentKey as RCK
    from hotproofs_tpu.nova.r1cs import ShapeDevice as RShape
    from hotproofs_tpu.ops import curve as RC
    r1cs, layout = compile_circuit(toy_step, P)
    shape = RShape.from_dsl(r1cs)
    ivc = RIVC(shape, RC.PALLAS, RCK.create(
        RC.PALLAS, b"toy", max(shape.n_wit, shape.n_cons)), None)
    wits, _ = witnesses(layout, CKPT_Z0, CKPT_STEPS)
    canon = np.stack([shape.field.batch_to_limbs([int(v) for v in w])
                      for w in wits])
    X = [[int(v) % P for v in w[1:3]] for w in wits]
    proof = ivc.prove_batch([CKPT_Z0], jnp.asarray(canon), X,
                            checkpoint_path=path,
                            checkpoint_every=CKPT_EVERY)
    return proof.to_dict()


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_toy_chain.py OUT.json
    # regenerates the reference checkpoint (and checks the reference's
    # proof of that chain against the proof fixture).
    import sys
    d = make_reference_checkpoint(sys.argv[1])
    assert json.dumps(d) == json.dumps(ref_dict()), "proof != fixture"
    print("checkpoint written to", sys.argv[1])
