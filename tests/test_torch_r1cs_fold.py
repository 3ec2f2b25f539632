"""Port R1CS shape, SpMV and fold on the real BLAKE3 Nova step circuit:
SpMV vs exact Python-int evaluation of the DSL R1CS on a real step
witness, relaxed satisfaction, and cross_term / fold_witness vs the
reference's nova.fold."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hotproofs_tpu.circuits import blake3_nova as nova_circ
from hotproofs_tpu.circuits.blake3_compression import VESTA_PRIME
from hotproofs_tpu.core import blake3_ref as b3
from hotproofs_tpu.nova import fold as RNF
from hotproofs_tpu.nova import r1cs as RR
from hotproofs_tpu.ops import field as RF
from hotproofs_tpu_torch.nova import fold as NF
from hotproofs_tpu_torch.nova.r1cs import ShapeDevice, matvec_all, \
    relaxed_satisfied
from hotproofs_tpu_torch.ops import field as F

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SPEC = F.pallas_scalar


@lru_cache(maxsize=None)
def _circuit():
    r1cs, _ = nova_circ.get_nova_step_circuit(VESTA_PRIME, 0, 8)
    return r1cs, ShapeDevice.from_dsl(r1cs)


def _step_witness():
    proof = b3.hash_with_path(bytes(range(256)) * 8, 1)
    sched = nova_circ.build_schedule(proof)
    z = [v % VESTA_PRIME for v in sched.z0]
    w, _ = nova_circ.eval_step_witness(z, sched.steps[0], VESTA_PRIME)
    return np.array([int(v) for v in w], dtype=object)


def test_shape_arrays_match_reference():
    """The arrays the pp digest hashes are the reference's, byte for byte."""
    r1cs, shape = _circuit()
    ref = RR.ShapeDevice.from_dsl(r1cs)
    assert (shape.n_cons, shape.n_vars, shape.n_io, shape.n_wit) == \
        (ref.n_cons, ref.n_vars, ref.n_io, ref.n_wit) == \
        (16162, 15953, 30, 15922)
    for name in ("A", "B", "C"):
        a, b = getattr(shape, name), getattr(ref, name)
        for f in ("rows", "cols", "vals_mont"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                (name, f)


def test_spmv_vs_python_ints_and_relaxed_check():
    r1cs, shape = _circuit()
    w = _step_witness()
    assert r1cs.is_satisfied(w)
    z = torch.from_numpy(SPEC.batch_to_limbs(list(w)))
    z_mont = F.to_mont(SPEC, z)
    got = matvec_all(shape, z_mont)
    for mat, g in zip((r1cs.A, r1cs.B, r1cs.C), got):
        want = [int(v) for v in r1cs.matvec(mat, w)]
        assert F.to_ints(SPEC, g, mont=True) == want
    # a batch axis gives the same rows
    got2 = matvec_all(shape, torch.stack([z_mont, z_mont]))
    assert all(torch.equal(a[1], b) for a, b in zip(got2, got))

    n_io = shape.n_io
    one = F.to_mont(SPEC, z[:1])[0]
    x, wit = z_mont[1:1 + n_io], z_mont[1 + n_io:]
    e = F.zeros((shape.n_cons,))
    assert relaxed_satisfied(shape, one, x, wit, e)
    bad = wit.clone()
    bad[100] = F.to_mont(SPEC, torch.from_numpy(
        SPEC.batch_to_limbs([12345])))[0]
    assert not relaxed_satisfied(shape, one, x, bad, e)


def _rand_mont(rng, n):
    return SPEC.batch_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % SPEC.p for _ in range(n)])


def test_cross_term_and_fold_witness_vs_reference():
    rng = np.random.default_rng(4)
    nw, nc = 6, 8
    acc_np = [_rand_mont(rng, n) for n in (nw, nc, nc, nc, nc)]
    az2, bz2, cz2, T = (_rand_mont(rng, nc) for _ in range(4))
    W2 = _rand_mont(rng, nw)
    u, r = _rand_mont(rng, 1)[0], _rand_mont(rng, 1)[0]
    t = lambda a: torch.from_numpy(np.asarray(a))
    acc = NF.AccumulatorDevice(*(t(a) for a in acc_np))
    racc = RNF.AccumulatorDevice(*(jnp.asarray(a) for a in acc_np))
    spec = RF.pallas_scalar

    got = NF.cross_term(SPEC, acc, t(az2), t(bz2), t(cz2), t(u))
    want = jax.jit(lambda *a: RNF.cross_term(spec, *a))(
        racc, az2, bz2, cz2, u)
    assert np.array_equal(got.numpy(), np.asarray(want))

    got = NF.fold_witness(SPEC, acc, t(W2), t(az2), t(bz2), t(cz2), t(T),
                          t(r))
    want = jax.jit(lambda *a: RNF.fold_witness(spec, *a))(
        racc, W2, az2, bz2, cz2, T, r)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))

    # K = 2 lockstep batch: row k equals the unbatched fold of chain k.
    acc2 = NF.AccumulatorDevice(*(torch.stack([a, a]) for a in acc))
    two = lambda a: torch.stack([t(a), t(a)])
    got2 = NF.fold_witness(SPEC, acc2, two(W2), two(az2), two(bz2),
                           two(cz2), two(T), torch.stack([t(r), t(u)]))
    got_u = NF.fold_witness(SPEC, acc, t(W2), t(az2), t(bz2), t(cz2), t(T),
                            t(u))
    for g2, g, gu in zip(got2, got, got_u):
        assert torch.equal(g2[0], g) and torch.equal(g2[1], gu)


def test_fold_instance_vs_reference():
    from hotproofs_tpu.ops import curve as RC
    from hotproofs_tpu_torch.ops import curve as C
    g = C.host_scalar_mul(C.PALLAS, 5, C.PALLAS.gen)
    inst = NF.AccumulatorInstance(u=3, X=[1, 2], comm_W=g, comm_E=None)
    rinst = RNF.AccumulatorInstance(u=3, X=[1, 2], comm_W=g, comm_E=None)
    q = C.host_scalar_mul(C.PALLAS, 7, C.PALLAS.gen)
    got = NF.fold_instance(SPEC, C.PALLAS, inst, [4, 5], q, g, 11)
    want = RNF.fold_instance(RF.pallas_scalar, RC.PALLAS, rinst, [4, 5], q,
                             g, 11)
    assert (got.u, got.X, got.comm_W, got.comm_E) == \
        (want.u, want.X, want.comm_W, want.comm_E)
