"""The port's Spartan argument for one strict step instance taken as
relaxed (u = 1, E = 0, comm_E the identity): the claim a compressed
recursive proof makes for its last primary instance (nova/recursive.py:
compress). tests/data/torch_wide_spartan_strict_ref.json.gz holds the JAX
package's instance and proof for the first step of the 60-product chain
of tests/spartan_chains.py (z_in = 5, the key b"wide-spartan"), on a bare
SpartanSystem over the chain's shape, key and pp digest. Made by the JAX
package on the CPU (about 20 minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/spartan_chains.py strict wide OUT.json.gz

and the slow test below makes it again and compares.
"""

import copy
import json

import pytest
import torch

from hotproofs_tpu_torch.nova import serial
from hotproofs_tpu_torch.nova import spartan as SP
from spartan_chains import (load_strict_ref, make_strict_reference,
                            port_stack, strict_claim)

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stack():
    """(bare SpartanSystem, instance, W, E, the fixture)."""
    ivc, _, layout = port_stack("wide")
    sps = SP.SpartanSystem(shape=ivc.shape, curve=ivc.curve, ck=ivc.ck,
                           pp_digest=ivc.pp_digest)
    return (sps,) + strict_claim("wide", ivc, layout) + (
        load_strict_ref("wide"),)


def test_the_instance_equals_the_reference(stack):
    sps, inst, W, E, ref = stack
    assert ref["pp_digest"] == sps.pp_digest
    assert ref["instance"] == {"u": 1, "x": serial.enc_ints(inst.X),
                               "cw": serial.enc_point(inst.comm_W),
                               "ce": serial.enc_point(None)}
    assert inst.comm_E is None and E == [0] * sps.shape.n_cons


def test_prove_relaxed_is_byte_equal_to_the_reference(stack):
    """Every L and R of the E opening commits to zeros: the identity."""
    sps, inst, W, E, ref = stack
    sp = sps.prove_relaxed(inst, W, E)
    assert json.dumps(sp.to_dict()) == json.dumps(ref["spartan"])
    assert sp.vE == 0 and len(sp.ipa_E.Ls) == sps.m.bit_length() - 1
    assert all(pt is None for pt in sp.ipa_E.Ls + sp.ipa_E.Rs)


def test_verify_relaxed_accepts_the_reference_and_refuses_a_changed_vE(
        stack):
    sps, inst, _, _, ref = stack
    sps.verify_relaxed(inst, SP.SpartanProof.from_dict(ref["spartan"]))
    bad = SP.SpartanProof.from_dict(copy.deepcopy(ref["spartan"]))
    bad.vE = 1
    with pytest.raises(AssertionError, match="sum-check 1 final claim"):
        sps.verify_relaxed(inst, bad)


@pytest.mark.slow  # the reference's XLA compiles: about 20 minutes on an 8-core CPU
def test_reference_regenerates_the_strict_fixture():
    assert json.dumps(make_strict_reference("wide")) == \
        json.dumps(load_strict_ref("wide"))
