"""Spartan's matrix tables H_M[x] = sum_y M[x, y] G_y (ops/tables.py, which
nova/spartan.py builds them with: the h_tables kernel on the card, its
plain torch version on the CPU) against the host loop of one fold_point a
nonzero that both packages used before (tests/spartan_chains.py:
host_tables), against the pure-Python host_add / host_scalar_mul, and
against the JAX package's own SpartanSystem.preprocess_H (host code, no
XLA compile). Exact equality throughout.

The rows come from the recursive SNARK's toy primary circuit (the
augmented verifier around z -> z^3 + 7 on Pallas): its first 16 rows, the
longest row of A, B and C (128, 65 and 259 nonzeros) and 24 seeded rows
holding full-width values, their columns folded onto a key of 64
generators. The kernel itself is held against this plain version on the
card (tests/test_torch_cuda_recursive.py, chip_smoke.py) and its per-lane
code under g++ (tests/test_torch_cuda_host.py).
"""

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.circuits import gadgets as g
from hotproofs_tpu_torch.circuits import nova_augmented as NA
from hotproofs_tpu_torch.circuits.dsl import compile_circuit
from hotproofs_tpu_torch.core import native_ff
from hotproofs_tpu_torch.nova import spartan as SP
from hotproofs_tpu_torch.nova.r1cs import ShapeDevice
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import poseidon as P
from hotproofs_tpu_torch.ops import tables as TB
from spartan_chains import P as SC_P
from spartan_chains import (CHAINS, STEPS, host_tables, port_stack,
                            small_key, sub_shape, table_test_rows)
from test_torch_recursive_fixtures import toy_gadget

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

KEY = 64


@pytest.fixture(scope="module")
def primary():
    """The toy augmented primary (vk 0, as the SNARK's probe)."""
    c = NA.make_augmented_circuit(
        P.make_spec(C.PALLAS.scalar.name), C.VESTA.b, C.VESTA.scalar.p, 0, 1,
        lambda ctx, z, e: toy_gadget(ctx, z, e, g), fold_at_base=True)
    r1cs, _ = compile_circuit(c, C.PALLAS.scalar.p)
    return ShapeDevice.from_dsl(r1cs)


@pytest.fixture(scope="module")
def sub(primary):
    """(shape, key, SpartanSystem, row lengths) of the sub-matrix."""
    rows = table_test_rows(primary, 24)
    shape, _ = sub_shape(primary, rows, KEY)
    ck = small_key(C.PALLAS, b"tables-test", KEY)
    sps = SP.SpartanSystem(shape=shape, curve=C.PALLAS, ck=ck, pp_digest=1)
    lens = [np.bincount(getattr(shape, k).rows).max() for k in "ABC"]
    return shape, ck, sps, lens


def test_the_rows_hold_full_width_negated_and_longest_values(sub):
    shape, _, sps, lens = sub
    csr = TB.table_csr(shape.field, [(d.rows, d.cols, d.vals) for d in (
        shape.dev[k] for k in "ABC")], sps.m)
    assert lens == [128, 65, 259]
    assert int((csr.mag[:, 7] != 0).sum()) > 100      # over 224 bits
    assert 0 < int(csr.neg.sum()) < csr.neg.shape[0]
    # mag is min(v, p - v), and neg says which.
    fs = shape.field
    v = fs.limbs_to_ints(np.concatenate([getattr(shape, k).vals_mont
                                         for k in "ABC"]))
    rinv = pow(fs.r_mod_p, fs.p - 2, fs.p)
    mag = F.words_to_digits(csr.mag).numpy()
    for i in range(0, len(v), 7):
        want = int(v[i]) * rinv % fs.p
        got = F.limbs_to_int(mag[i])
        assert got <= fs.p // 2
        assert (fs.p - got if csr.neg[i] else got) == want
    # The rows run longest walk first (the most adds of any lane of the
    # row's warp under its lane map); each row's nonzeros stay in CSR order.
    n = TB.value_counts(csr.row_ptr, csr.mag)
    _, _, _, a, _ = TB.lane_map(csr.alloc)
    walk = TB.row_walk(n, a).numpy()
    assert list(walk[csr.order.numpy()]) == sorted(walk, reverse=True)
    assert walk.max() < max(lens)


def test_plain_tables_equal_the_host_loop(sub):
    shape, ck, sps, _ = sub
    got = sps._build_H()
    want = host_tables(shape, ck, sps.m)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert want[2][:, shape.n_cons:].all()       # padding rows: identity


def test_plain_tables_equal_pure_python_host_ops(primary, sub, monkeypatch):
    """host_add / host_scalar_mul instead of the native fold_point, on the
    first 4 rows and 2 full-width ones."""
    rows = table_test_rows(primary, 2, seed=1, head=4, longest=False)
    shape, _ = sub_shape(primary, rows, 16)
    ck = sub[1]
    sps = SP.SpartanSystem(shape=shape, curve=C.PALLAS, ck=ck, pp_digest=2)
    got = sps._build_H()
    monkeypatch.setattr(native_ff, "available", lambda: False)
    want = host_tables(shape, ck, sps.m)
    assert not want[2][:, :shape.n_cons].all()
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", ["toy", "wide"])
def test_plain_tables_equal_the_reference_preprocess(name):
    """The JAX package's tables of the two Spartan chains (its host loop
    over its own shape and key) equal the port's."""
    from hotproofs_tpu.circuits import gadgets as rg
    from hotproofs_tpu.circuits.dsl import compile_circuit as r_compile
    from hotproofs_tpu.nova.ivc import IVC as RIVC
    from hotproofs_tpu.nova.pedersen import CommitmentKey as RCK
    from hotproofs_tpu.nova.r1cs import ShapeDevice as RShape
    from hotproofs_tpu.nova.spartan import SpartanSystem as RSpartan
    from hotproofs_tpu.ops import curve as RC

    ivc, sps, _ = port_stack(name)
    r1cs, _ = r_compile(lambda ctx: STEPS[name](ctx, rg), SC_P)
    rivc = RIVC(RShape.from_dsl(r1cs), RC.PALLAS,
                RCK.create(RC.PALLAS, CHAINS[name][0], ivc.ck.n), None)
    assert rivc.pp_digest == ivc.pp_digest
    ref = RSpartan(rivc).preprocess_H()
    xs, ys, inf = sps._build_H()
    for mi, (x, y, z) in enumerate(ref):
        live = ~inf[mi]
        assert np.array_equal(~np.asarray(z).any(-1), inf[mi])
        assert np.array_equal(np.asarray(x)[live], xs[mi][live])
        assert np.array_equal(np.asarray(y)[live], ys[mi][live])
    assert live.any()
