"""Port batched witness generator (circuits/witness_torch.py) vs the host
DSL evaluator on a real chain, bit for bit, with the inverse hints patched;
and vs the JAX batched generator (slow)."""

import numpy as np
import pytest
import torch

from hotproofs_tpu.circuits import blake3_nova as nova_circ
from hotproofs_tpu.circuits.blake3_compression import VESTA_PRIME
from hotproofs_tpu.core import blake3_ref as b3
from hotproofs_tpu_torch.circuits import witness_torch as WT
from hotproofs_tpu_torch.ops import field as F

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _chain(data, chunk):
    proof = b3.hash_with_path(data, chunk)
    zs, sched = nova_circ.z_chain(proof, VESTA_PRIME)
    return zs, sched


def _batch(zs, sched):
    n = len(sched.steps)
    t = lambda x: torch.as_tensor(np.asarray(x, np.int64))
    return WT.batched_nova_witness(
        t(zs[:n]), t([s.m for s in sched.steps]),
        t([s.b for s in sched.steps]), t([s.down_left for s in sched.steps]))


@pytest.mark.parametrize("data_len,chunk", [(2400, 2), (1028, 0), (68, 0)])
def test_batched_matches_host_full_chain(data_len, chunk):
    data = bytes(range(200)) * (data_len // 200 + 1)
    zs, sched = _chain(data[:data_len], chunk)
    w = _batch(zs, sched)
    big = WT.nova_big_positions(VESTA_PRIME)
    z = [v % VESTA_PRIME for v in sched.z0]
    for i, step in enumerate(sched.steps):
        w_host, z_out = nova_circ.eval_step_witness(z, step, VESTA_PRIME)
        got = [int(v) for v in w[i].tolist()]
        for pos, val in zip(big, WT.nova_inverse_values(
                z[11], z[1], z[0], VESTA_PRIME)):
            got[pos] = val
        want = [int(v) for v in w_host]
        assert len(got) == len(want)
        mism = [k for k in range(len(want)) if got[k] != want[k]]
        assert not mism, f"step {i}: mismatch at signals {mism[:10]}"
        assert [int(v) for v in zs[i + 1]] == z_out
        z = z_out


def test_witness_canon_patches_inverse_hints():
    zs, sched = _chain(bytes(1028), 0)
    w = _batch(zs, sched)
    big = WT.nova_big_positions(VESTA_PRIME)
    inv = np.zeros((w.shape[0], 3, 32), np.int32)
    for i, z in enumerate(zs[:w.shape[0]]):
        for j, v in enumerate(WT.nova_inverse_values(z[11], z[1], z[0])):
            inv[i, j] = F.int_to_limbs(v)
    canon = WT.witness_canon(w, big, torch.from_numpy(inv))
    spec = F.pallas_scalar
    z = [v % VESTA_PRIME for v in sched.z0]
    for i, step in enumerate(sched.steps):
        w_host, z = nova_circ.eval_step_witness(z, step, VESTA_PRIME)
        assert F.to_ints(spec, canon[i]) == [int(v) for v in w_host]


@pytest.mark.slow  # the JAX generator's XLA:CPU compile takes minutes
def test_batched_matches_jax_generator():
    import jax.numpy as jnp
    from hotproofs_tpu.circuits import witness_jax as WJ

    zs, sched = _chain(bytes(range(200)) * 12, 2)
    n = len(sched.steps)
    got = _batch(zs, sched).numpy()
    want = np.asarray(WJ.jitted_nova_generator(0, 8)(
        jnp.asarray(np.array(zs[:n], np.uint32)),
        jnp.asarray(np.array([s.m for s in sched.steps], np.uint32)),
        jnp.asarray(np.array([s.b for s in sched.steps], np.uint32)),
        jnp.asarray(np.array([s.down_left for s in sched.steps],
                             np.uint32))))
    assert np.array_equal(got, want.astype(np.int64))
