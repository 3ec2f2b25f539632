"""The port's inner-product argument (nova/spartan.py _IPA), which never
folds its generators: each round commits L and R by one J = 2 MSM over the
key's prepared bases with the scalars weighted by products of the
challenges. Held against a host prover that folds the generators as the
reference does (hotproofs_tpu/nova/spartan.py _fold: x^-1 G_lo + x G_hi),
on the same transcript, and against the port's own verifier.

On the CPU the MSM and the field products take their plain versions.
"""

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.nova import spartan as SP
from hotproofs_tpu_torch.nova.pedersen import CommitmentKey
from hotproofs_tpu_torch.nova.transcript import Transcript
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import field as F

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

KEY_N = 16
CURVES = ("pallas", "bn254")


@pytest.fixture(scope="module")
def keys():
    """Per curve: (spec, key of KEY_N generators with its bases prepared
    once, the generators as host affine points, the IPA)."""
    out = {}
    for name in CURVES:
        spec = C.CURVES[name]
        f = spec.base
        gens = C.derive_generators(spec, b"test-torch-ipa", KEY_N)
        limbs = np.asarray([[F.int_to_limbs(f.to_mont_int(x)),
                             F.int_to_limbs(f.to_mont_int(y))]
                            for x, y in gens], np.int32)
        ck = CommitmentKey(spec, KEY_N, limbs)
        ck.scaled_affine(KEY_N, 256)   # every prefix below reuses it
        (ux, uy), = C.derive_generators(spec, b"test-torch-ipa-u", 1)
        out[name] = (spec, ck, gens, SP._IPA(spec, spec.scalar, (ux, uy), ck))
    return out


def _instance(spec, gens, n, seed):
    """Seeded a, b of n scalars, P = <a, G> and v = <a, b>."""
    p = spec.scalar.p
    rng = np.random.default_rng(seed)
    a, b = ([int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
            for _ in range(2))
    return a, b, C.host_msm(spec, a, gens[:n]), sum(
        x * y for x, y in zip(a, b)) % p


def _transcript(spec):
    return Transcript(spec.scalar.name, b"test-ipa", 12345)


def _prove(spec, ipa, a, b, P, v):
    fs = spec.scalar
    return ipa.prove_weighted(_transcript(spec), len(a),
                              F.from_ints(fs, a, mont=True),
                              F.from_ints(fs, b, mont=True), P, v)


def _host_fold_prove(spec, ipa, gens, a, b, P, v):
    """The reference's prover on the host: cross terms, L = <a_lo, G_hi> +
    cl U_c and R = <a_hi, G_lo> + cr U_c by host MSMs, then a, b and the
    generators folded (G' = x^-1 G_lo + x G_hi). -> (Ls, Rs, a_final, the
    challenges)."""
    p = spec.scalar.p
    tr = _transcript(spec)
    Uc = ipa._u_point(tr, P, v)
    G = list(gens[:len(a)])
    Ls, Rs, xs = [], [], []
    while len(a) > 1:
        h = len(a) // 2
        cl = sum(x * y for x, y in zip(a[:h], b[h:])) % p
        cr = sum(x * y for x, y in zip(a[h:], b[:h])) % p
        L = C.host_add(spec, C.host_msm(spec, a[:h], G[h:]),
                       C.host_scalar_mul(spec, cl, Uc))
        R = C.host_add(spec, C.host_msm(spec, a[h:], G[:h]),
                       C.host_scalar_mul(spec, cr, Uc))
        tr.absorb_point(L)
        tr.absorb_point(R)
        x = tr.challenge()
        xi = pow(x, p - 2, p)
        a = [(x * lo + xi * hi) % p for lo, hi in zip(a[:h], a[h:])]
        b = [(xi * lo + x * hi) % p for lo, hi in zip(b[:h], b[h:])]
        G = [C.host_add(spec, C.host_scalar_mul(spec, xi, lo),
                        C.host_scalar_mul(spec, x, hi))
             for lo, hi in zip(G[:h], G[h:])]
        Ls.append(L)
        Rs.append(R)
        xs.append(x)
    return Ls, Rs, a[0], xs


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_rounds_equal_a_host_fold(keys, name, n):
    """Every round's L and R, and the final a, equal the host prover's,
    which folds the generators."""
    spec, ck, gens, ipa = keys[name]
    a, b, P, v = _instance(spec, gens, n, seed=n)
    proof, _ = _prove(spec, ipa, a, b, P, v)
    Ls, Rs, a_final, _ = _host_fold_prove(spec, ipa, gens, a, b, P, v)
    assert len(proof.Ls) == n.bit_length() - 1
    assert proof.Ls == Ls
    assert proof.Rs == Rs
    assert proof.a_final == a_final


@pytest.mark.parametrize("name", CURVES)
def test_final_weights_equal_the_verifiers(keys, name, monkeypatch):
    """The prover's final w (canonical digits) is the weight list that
    _IPA.verify commits to for the folded generator, and sum w_i G_i is the
    host's folded generator."""
    spec, ck, gens, ipa = keys[name]
    n = 8
    a, b, P, v = _instance(spec, gens, n, seed=40)
    proof, w = _prove(spec, ipa, a, b, P, v)
    got = F.to_ints(spec.scalar, w)
    seen = []
    commit = ck.commit
    monkeypatch.setattr(ck, "commit", lambda sc, *r: seen.append(
        F.to_ints(spec.scalar, sc)) or commit(sc, *r))
    assert ipa.verify(_transcript(spec), n,
                      F.from_ints(spec.scalar, b, mont=True), P, v, proof)
    assert seen == [got]
    _, _, _, xs = _host_fold_prove(spec, ipa, gens, a, b, P, v)
    p = spec.scalar.p
    G = list(gens[:n])
    for x in xs:
        h = len(G) // 2
        G = [C.host_add(spec, C.host_scalar_mul(spec, pow(x, p - 2, p), lo),
                        C.host_scalar_mul(spec, x, hi))
             for lo, hi in zip(G[:h], G[h:])]
    assert C.host_msm(spec, got, gens[:n]) == G[0]


@pytest.mark.parametrize("name", CURVES)
def test_verify_accepts_the_proof(keys, name):
    spec, ck, gens, ipa = keys[name]
    a, b, P, v = _instance(spec, gens, 4, seed=50)
    proof, _ = _prove(spec, ipa, a, b, P, v)
    assert ipa.verify(_transcript(spec), 4,
                      F.from_ints(spec.scalar, b, mont=True), P, v, proof)


@pytest.mark.parametrize("name", CURVES)
def test_verify_refuses_a_changed_L(keys, name):
    spec, ck, gens, ipa = keys[name]
    a, b, P, v = _instance(spec, gens, 4, seed=60)
    proof, _ = _prove(spec, ipa, a, b, P, v)
    proof.Ls[1] = C.host_add(spec, proof.Ls[1], spec.gen)
    assert not ipa.verify(_transcript(spec), 4,
                          F.from_ints(spec.scalar, b, mont=True), P, v,
                          proof)
