"""The port's recursive SNARK (nova/recursive.py) against the reference at
the circuit level: the augmented circuits compile to the reference's R1CS,
the host RO / fold mirrors give the reference's values, and the circuits'
in-circuit folds agree with the mirrors (the reference's fast tests of
tests/test_recursive.py, ported). No commitment is made here: the chains
with the commitment oracle are tests/test_torch_recursive_chains.py and
tests/test_torch_recursive_chunk.py, the card's real commitments
tests/test_torch_cuda_recursive.py."""

import hashlib

import numpy as np
import pytest
import torch

from hotproofs_tpu.circuits import blake3_nova as R_nova
from hotproofs_tpu.circuits import dsl as R_dsl
from hotproofs_tpu.circuits import gadgets as R_g
from hotproofs_tpu.circuits import nova_augmented as R_NA
from hotproofs_tpu.nova import recursive as RR
from hotproofs_tpu.ops import curve as R_C
from hotproofs_tpu.ops import poseidon as R_P
from hotproofs_tpu_torch.circuits import blake3_nova as nova
from hotproofs_tpu_torch.circuits import dsl
from hotproofs_tpu_torch.circuits import gadgets as g
from hotproofs_tpu_torch.circuits import nova_augmented as NA
from hotproofs_tpu_torch.nova import recursive as R
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import poseidon as P
from test_torch_recursive_fixtures import port_snark, toy_gadget, toy_host

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

CYCLES = {"pasta": ("pallas", "vesta"), "bn254": ("bn254", "grumpkin")}


@pytest.fixture(scope="module")
def snarks():
    """The port's toy RecursiveSNARKs on the CPU, by cycle (the reference
    tests' labels)."""
    return {"pasta": port_snark(),
            "bn254": port_snark(CYCLES["bn254"], b"test-recursive-bn")}


def _r1cs_digest(r1cs) -> str:
    h = hashlib.sha256(repr((r1cs.modulus, r1cs.n_signals,
                             r1cs.n_constraints, r1cs.n_io)).encode())
    for rows, cols, vals in (r1cs.A, r1cs.B, r1cs.C):
        h.update(np.asarray(rows, np.int64).tobytes()
                 + np.asarray(cols, np.int64).tobytes()
                 + repr([int(v) for v in vals]).encode())
    return h.hexdigest()


def _augmented(which, curves, NAm, Pm, gm, nvm):
    """(circuit, field) of one augmented circuit built with the given
    package's modules; vk is a seeded 250-bit value."""
    cur1, cur2 = (C.CURVES[c] for c in curves)
    q, p = cur1.scalar.p, cur2.scalar.p
    vk = int.from_bytes(np.random.default_rng(5).bytes(31), "little") \
        % (1 << NA.CHALLENGE_BITS)
    if which == "secondary":
        return NAm.make_augmented_circuit(
            Pm.make_spec(cur2.scalar.name), cur1.b, q, vk, 0, None,
            fold_at_base=False), p
    if which == "toy":
        f, arity, decl = (lambda ctx, z, e: toy_gadget(ctx, z, e, gm)), 1, \
            None
    else:
        f = lambda ctx, z, e: nvm.nova_step_body(ctx, z, e, 0, 8)
        arity, decl = nvm.IO_ARITY, nvm.declare_step_inputs
    return NAm.make_augmented_circuit(
        Pm.make_spec(cur1.scalar.name), cur2.b, p, vk, arity, f,
        fold_at_base=True, f_extra_decl=decl), q


@pytest.mark.parametrize("which,cycle", [
    ("toy", "pasta"), ("blake3", "pasta"), ("secondary", "pasta"),
    ("toy", "bn254")], ids=["toy-primary", "blake3-primary", "secondary",
                            "bn254-toy-primary"])
def test_augmented_r1cs_matches_the_reference(which, cycle):
    """Matrix for matrix, with the same layout of named segments."""
    circ, mod = _augmented(which, CYCLES[cycle], NA, P, g, nova)
    r_circ, r_mod = _augmented(which, CYCLES[cycle], R_NA, R_P, R_g, R_nova)
    ours, layout = dsl.compile_circuit(circ, mod)
    ref, r_layout = R_dsl.compile_circuit(r_circ, r_mod)
    assert (ours.n_constraints, ours.n_signals, ours.n_io) == \
        (ref.n_constraints, ref.n_signals, ref.n_io)
    assert ours.n_io == 2 and ours.n_constraints > 30000
    assert _r1cs_digest(ours) == _r1cs_digest(ref)
    assert [(s.name, s.start, s.length, s.role) for s in layout.segments] \
        == [(s.name, s.start, s.length, s.role) for s in r_layout.segments]


def _seeded_state(cycle: str, seed: int):
    """A seeded running instance U, strict u and T_bar on the secondary's
    commitment curve (scalars over the primary circuit's other field)."""
    cur2 = C.CURVES[CYCLES[cycle][1]]
    p = cur2.scalar.p
    rng = np.random.default_rng(seed)
    rnd = lambda: int.from_bytes(rng.bytes(32), "little") % p
    pts = C.derive_generators(cur2, b"test-rec-pts-%d" % seed, 4)
    U = dict(comm_W=pts[0], comm_E=pts[1], u=rnd(), X=(rnd(), rnd()))
    u = dict(comm_W=pts[2], X=(rnd(), rnd()))
    return U, u, pts[3], p, rnd


@pytest.mark.parametrize("cycle", ["pasta", "bn254"])
def test_host_mirrors_match_the_reference(cycle):
    """state_hash_host, fold_challenge_host and fold_relaxed_host on
    seeded inputs, both sponges of the cycle, base and running instances."""
    name1, name2 = CYCLES[cycle]
    for seed in (1, 2):
        U, u, T, p, rnd = _seeded_state(cycle, seed)
        vk, k = rnd() % (1 << 250), 7 + seed
        for Ud, ud, Tb in ((U, u, T), ({}, {}, None)):
            ours_U, ref_U = R.RelaxedHost(**Ud), RR.RelaxedHost(**Ud)
            ours_u, ref_u = R.StrictHost(**ud), RR.StrictHost(**ud)
            for name in (name1, name2):
                spec, r_spec = P.make_spec(C.CURVES[name].scalar.name), \
                    R_P.make_spec(R_C.CURVES[name].scalar.name)
                z0, z = [5, 6], [rnd(), rnd()]
                assert R.state_hash_host(spec, vk, k, z0, z, ours_U) == \
                    RR.state_hash_host(r_spec, vk, k, z0, z, ref_U)
                assert R.state_hash_host(spec, vk, k, None, None, ours_U) \
                    == RR.state_hash_host(r_spec, vk, k, None, None, ref_U)
                assert R.fold_challenge_host(spec, vk, ours_U, ours_u, Tb) \
                    == RR.fold_challenge_host(r_spec, vk, ref_U, ref_u, Tb)
            r = rnd() % (1 << 250)
            curve = C.CURVES[name2]
            got = R.fold_relaxed_host(curve, p, ours_U, ours_u, Tb, r)
            want = RR.fold_relaxed_host(R_C.CURVES[name2], p, ref_U, ref_u,
                                        Tb, r)
            assert (got.comm_W, got.comm_E, got.u, tuple(got.X)) == \
                (want.comm_W, want.comm_E, want.u, tuple(want.X))


def _eval_outputs(side, inputs):
    w = dsl.eval_witness(side.circuit_fn, side.layout, inputs)
    return (int(w[1]), int(w[2])), w


@pytest.mark.parametrize("cycle", ["pasta", "bn254"])
def test_base_case_circuit_matches_host(snarks, cycle):
    """C1 at k = 1 (the base): constraints hold, and the output hash is
    the host mirror's after folding u2 into the default U2."""
    snark = snarks[cycle]
    cur2 = C.CURVES[CYCLES[cycle][1]]
    host = toy_host(snark.q)
    z0 = [5]
    u2 = R.StrictHost(comm_W=None, X=(0, 0))
    inputs = {"k_prev": [0], "z0": z0, "z_prev": z0,
              **R._relaxed_inputs("U", R.RelaxedHost()),
              **R._strict_inputs("u", u2),
              "T_cw": R._pt_enc(None)}
    (h, echo), _ = _eval_outputs(snark.side1, inputs)
    r = R.fold_challenge_host(snark.pspec1, snark.vk, R.RelaxedHost(), u2,
                              None)
    U2_next = R.fold_relaxed_host(cur2, snark.p, R.RelaxedHost(), u2, None,
                                  r)
    want = R.state_hash_host(snark.pspec1, snark.vk, 1, z0, host(z0),
                             U2_next)
    assert h == want
    assert echo == 0


def test_nonbase_fold_matches_host_mirror(snarks):
    """C1 at k = 3 with a made-up consistent prior state: the in-circuit
    NIFS (RO, native EC, foreign BigNat folds) reproduces the host fold
    exactly, through the output state hash."""
    snark = snarks["pasta"]
    p, q = snark.p, snark.q
    Ud, ud, T_bar, _, rnd = _seeded_state("pasta", 11)
    z0, z_prev = [5], [1234567]
    U2_prev = R.RelaxedHost(**Ud)
    h_prev = R.state_hash_host(snark.pspec1, snark.vk, 2, z0, z_prev,
                               U2_prev)
    u2 = R.StrictHost(comm_W=ud["comm_W"], X=(ud["X"][0], h_prev))
    inputs = {"k_prev": [2], "z0": z0, "z_prev": z_prev,
              **R._relaxed_inputs("U", U2_prev),
              **R._strict_inputs("u", u2),
              "T_cw": R._pt_enc(T_bar)}
    (h, echo), _ = _eval_outputs(snark.side1, inputs)
    r = R.fold_challenge_host(snark.pspec1, snark.vk, U2_prev, u2, T_bar)
    U2_next = R.fold_relaxed_host(C.VESTA, p, U2_prev, u2, T_bar, r)
    want = R.state_hash_host(snark.pspec1, snark.vk, 3, z0,
                             toy_host(q)(z_prev), U2_next)
    assert h == want
    assert echo == u2.X[0] % q


def test_nonbase_rejects_wrong_echo(snarks):
    snark = snarks["pasta"]
    inputs = {"k_prev": [1], "z0": [5], "z_prev": [99],
              **R._relaxed_inputs("U", R.RelaxedHost()),
              **R._strict_inputs("u", R.StrictHost(comm_W=None,
                                                   X=(0, 12345))),
              "T_cw": R._pt_enc(None)}
    with pytest.raises(AssertionError):
        _eval_outputs(snark.side1, inputs)


def test_secondary_base_outputs_default(snarks):
    """C2 at k = 1: no fold (there is no u1_0); the output hash is of the
    default U1."""
    snark = snarks["pasta"]
    inputs = {"k_prev": [0],
              **R._relaxed_inputs("U", R.RelaxedHost()),
              **R._strict_inputs("u", R.StrictHost()),
              "T_cw": R._pt_enc(None)}
    (h, echo), _ = _eval_outputs(snark.side2, inputs)
    want = R.state_hash_host(snark.pspec2, snark.vk, 1, None, None,
                             R.RelaxedHost())
    assert h == want and echo == 0


def test_snark_sizes_and_lazy_keys(snarks):
    """Both sides' commit width is the power of two over max(n_wit,
    n_cons), and no key is derived before the first real commit."""
    for snark in snarks.values():
        for side in (snark.side1, snark.side2):
            n = max(side.shape.n_wit, side.shape.n_cons)
            assert side.n_pad == 1 << (n - 1).bit_length() == 32768
            assert side._ck is None


def test_snark_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.RecursiveSNARK(None, None, 1)
