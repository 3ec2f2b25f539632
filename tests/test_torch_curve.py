"""Port curve ops (plain torch RCB15 Algorithms 7, 8, 9) vs the JAX
reference's Pallas curve ops in interpret mode (projective, bit for bit)
and vs the host oracle; generator derivation vs the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotproofs_tpu.ops import curve as RC
from hotproofs_tpu.ops import pallas_curve as PC
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _points(spec, n, seed):
    rng = np.random.default_rng(seed)
    return [C.host_scalar_mul(
        spec, max(1, int.from_bytes(rng.bytes(32), "little")
                  % spec.scalar.p), spec.gen) for _ in range(n)]


def _rows(pt):
    """Port (n, 32) x3 digits -> the reference's limb-major (32, n) rows."""
    return tuple(jnp.asarray(c.numpy().T) for c in pt)


def _unrows(rows):
    return tuple(np.asarray(r).T for r in rows)


@pytest.mark.parametrize("name", ["pallas", "bn254", "grumpkin"])
def test_pt_add_vs_pallas_interpret_and_oracle(name):
    spec, rspec = C.CURVES[name], RC.CURVES[name]
    ps, qs = _points(spec, 8, 1), _points(spec, 8, 2)
    ps[0] = None                                   # identity + Q
    qs[1] = None                                   # P + identity
    qs[2] = ps[2]                                  # doubling through add
    qs[3] = (ps[3][0], (-ps[3][1]) % spec.base.p)  # P + (-P)
    P, Q = C.affine_to_mont(spec, ps), C.affine_to_mont(spec, qs)
    got = C.pt_add(spec, P, Q)
    ref = jax.jit(PC.pt_add_rows)(PC.curve_consts_dev(rspec), _rows(P),
                                  _rows(Q))
    for g, r in zip(got, _unrows(ref)):
        assert np.array_equal(g.numpy(), r)
    want = [RC.host_add(rspec, a, b) for a, b in zip(ps, qs)]
    assert C.pt_to_affine_host(spec, got) == want
    canon = tuple(F.from_mont(spec.base, c) for c in got)
    assert C.pt_to_affine_host_canon(spec, canon) == want


def test_pt_add_mixed_and_double_vs_pallas_interpret():
    spec, rspec = C.PALLAS, RC.PALLAS
    ps, qs = _points(spec, 8, 3), _points(spec, 8, 4)
    ps[0] = None
    ps[1] = qs[1]
    ps[2] = (qs[2][0], (-qs[2][1]) % spec.base.p)
    P, Q = C.affine_to_mont(spec, ps), C.affine_to_mont(spec, qs)
    cc = PC.curve_consts_dev(rspec)
    got = C.pt_add_mixed(spec, P, (Q[0], Q[1]))
    qr = _rows(Q)
    ref = jax.jit(PC.pt_add_mixed_rows)(cc, _rows(P), (qr[0], qr[1]))
    for g, r in zip(got, _unrows(ref)):
        assert np.array_equal(g.numpy(), r)
    assert C.pt_to_affine_host(spec, got) == [
        RC.host_add(rspec, a, b) for a, b in zip(ps, qs)]
    dbl = C.pt_double(spec, P)
    ref = jax.jit(PC.pt_double_rows)(cc, _rows(P))
    for g, r in zip(dbl, _unrows(ref)):
        assert np.array_equal(g.numpy(), r)
    assert C.pt_to_affine_host(spec, dbl) == [
        RC.host_add(rspec, a, a) for a in ps]
    neg = C.pt_to_affine_host(spec, C.pt_neg(spec, P))
    assert neg == [None if a is None else (a[0], (-a[1]) % spec.base.p)
                   for a in ps]


def test_select_and_identity():
    spec = C.PALLAS
    P = C.affine_to_mont(spec, _points(spec, 4, 5))
    ident = C.identity(spec, (4,))
    mask = torch.tensor([True, False, True, False])
    sel = C.pt_select(mask, P, ident)
    assert C.pt_to_affine_host(spec, sel)[1::2] == [None, None]
    assert C.pt_to_affine_host(spec, sel)[0::2] == \
        C.pt_to_affine_host(spec, P)[0::2]


@pytest.mark.parametrize("name", ["pallas", "vesta", "bn254", "grumpkin"])
def test_pt_from_affine_and_pt_stack_vs_reference(name):
    """pt_from_affine (coordinates past p reduce) and pt_stack give the
    reference's digits."""
    spec, rspec = C.CURVES[name], RC.CURVES[name]
    pts = _points(spec, 3, len(name))
    pts[2] = (pts[2][0] + spec.base.p, pts[2][1] - spec.base.p)
    ours = [C.pt_from_affine(spec, x, y) for x, y in pts]
    refs = [RC.pt_from_affine(rspec, x, y) for x, y in pts]
    for o, r in zip(ours, refs):
        assert all(c.dtype == torch.int32 and c.shape == (32,) for c in o)
        assert all(np.array_equal(c.numpy(), np.asarray(rc))
                   for c, rc in zip(o, r))
    got, want = C.pt_stack(ours), RC.pt_stack(refs)
    assert all(np.array_equal(g.numpy(), np.asarray(w))
               for g, w in zip(got, want))
    assert C.pt_to_affine_host(spec, got) == \
        [(x % spec.base.p, y % spec.base.p) for x, y in pts]


@pytest.mark.parametrize("name", ["pallas", "vesta", "bn254", "grumpkin"])
def test_pooled_generator_derivation_matches_reference_and_serial(name):
    """The derivation split over worker processes concatenates to the
    serial derivation and to the reference's, index for index."""
    spec = C.CURVES[name]
    label, n = b"pooled-" + name.encode(), 300
    pooled = C._derive_pooled(spec, label, n, 4)
    serial = C.H2C.derive_range(spec.name, spec.base.p, spec.b, label, 0, n)
    assert pooled == serial == RC.derive_generators(RC.CURVES[name], label, n)
    assert all(C.host_on_curve(spec, pt) for pt in pooled[:8])


def test_derive_generators_matches_reference():
    assert C.derive_generators(C.PALLAS, b"toy", 8) == \
        RC.derive_generators(RC.PALLAS, b"toy", 8)
    assert C.derive_generators(C.BN254, b"x", 4) == \
        RC.derive_generators(RC.BN254, b"x", 4)


def test_curve_specs_match_reference():
    for name, spec in C.CURVES.items():
        r = RC.CURVES[name]
        assert (spec.base.p, spec.scalar.p, spec.b, spec.gen) == \
            (r.base.p, r.scalar.p, r.b, r.gen)
        assert np.array_equal(spec.b3_mont, r.b3_mont)
