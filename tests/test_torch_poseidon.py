"""The port's batched Poseidon permutation (hotproofs_tpu_torch.ops.poseidon:
permute, its plain version on the CPU) against the reference's
jax.jit(permute) and host_permute on the same seeded states; its constants
against the reference's _device_constants; neptune_domain_tag against the
reference's. Exact equality everywhere."""

import jax
import numpy as np
import pytest
import torch

from hotproofs_tpu.ops import poseidon as RP
from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import poseidon as P

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

# (field, t, parameterisation): the eight specs of chip_smoke.py's phase 13.
SPECS = [("pallas_scalar", 3, "default"), ("vesta_scalar", 3, "default"),
         ("pallas_scalar", 3, "neptune"), ("vesta_scalar", 3, "neptune"),
         ("bn254_scalar", 3, "default"), ("grumpkin_scalar", 3, "default"),
         ("pallas_scalar", 5, "default"), ("pallas_scalar", 9, "default")]
BATCHES = [(), (2,), (4, 5)]


def _specs(field, t, kind):
    if kind == "neptune":
        return (P.make_spec_neptune(field, t - 1),
                RP.make_spec_neptune(field, t - 1))
    return P.make_spec(field, t), RP.make_spec(field, t)


def _states(spec, batch, seed):
    """Seeded canonical Montgomery digits of shape batch + (t, 32), the
    first state all p - 1 and, in a batch of several, the second all 0."""
    fld = spec.field
    rng = np.random.default_rng(seed)
    n = int(np.prod(batch, dtype=np.int64)) * spec.t
    vals = [int.from_bytes(rng.bytes(32), "little") % fld.p
            for _ in range(n)]
    vals[:spec.t] = [fld.p - 1] * spec.t
    if n > spec.t:
        vals[spec.t:2 * spec.t] = [0] * spec.t
    return fld.batch_to_limbs(vals).reshape(batch + (spec.t, 32))


@pytest.mark.parametrize("batch", BATCHES, ids=lambda b: f"batch{b}")
@pytest.mark.parametrize("field,t,kind", SPECS)
def test_permute_matches_reference_and_host(field, t, kind, batch):
    spec, rspec = _specs(field, t, kind)
    assert (spec.round_constants, spec.mds) == \
        (rspec.round_constants, rspec.mds)
    x = _states(spec, batch, seed=t + len(batch) + len(field))
    got = P.permute(spec, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.int32
    want = jax.jit(lambda s: RP.permute(rspec, s))(x)
    assert np.array_equal(got.numpy(), np.asarray(want))
    fld = spec.field
    ins = F.to_ints(fld, torch.from_numpy(x), mont=True)
    outs = F.to_ints(fld, got, mont=True)
    for k in range(0, len(ins), t):
        assert outs[k:k + t] == P.host_permute(spec, ins[k:k + t])


@pytest.mark.parametrize("field,t,kind", SPECS)
def test_device_constants_match_reference(field, t, kind):
    spec, rspec = _specs(field, t, kind)
    rc, mds, mask = P.device_constants(spec)
    want = RP._device_constants(rspec)
    for got, ref in zip((rc, mds, mask), want):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref)
    assert int(mask.sum()) == spec.r_full
    assert P.device_constants(spec) is P.device_constants(spec)


def test_neptune_domain_tag_matches_reference():
    for arity in range(1, 9):
        assert P.neptune_domain_tag(arity=arity) == \
            RP.neptune_domain_tag(arity=arity) == (1 << arity) - 1
    for n in (0, 1, 2, 7, 1 << 20, (1 << 64) - 1):
        assert P.neptune_domain_tag(const_len=n) == \
            RP.neptune_domain_tag(const_len=n) == n << 64
    for bad in ({}, {"arity": 2, "const_len": 2}):
        with pytest.raises(AssertionError):
            P.neptune_domain_tag(**bad)


def test_permute_takes_any_width_on_the_cpu_and_checks_its_input():
    """The plain version takes any t (the kernel only 3, 5 and 9), and the
    wrapper refuses a wrong dtype or shape."""
    spec, rspec = _specs("bn254_scalar", 2, "default")
    x = _states(spec, (3,), seed=2)
    got = P.permute(spec, torch.from_numpy(x))
    assert np.array_equal(
        got.numpy(), np.asarray(jax.jit(lambda s: RP.permute(rspec, s))(x)))
    with pytest.raises(TypeError):
        P.permute(spec, torch.from_numpy(x).to(torch.int64))
    with pytest.raises(ValueError):
        P.permute(spec, torch.from_numpy(x)[..., :16])
    with pytest.raises(ValueError):
        P.permute(P.make_spec("bn254_scalar"), torch.from_numpy(x))
