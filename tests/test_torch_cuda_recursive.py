"""The recursive SNARK on the card with real commitments: the reference
tests' toy chain on Pasta and on BN254/Grumpkin (2 steps each), the Pasta
one byte-equal to the reference's proof where tests/data holds it
(tests/data/torch_toy_recursive_ref.json.gz), and ChunkProver's 1-block
prove_recursive; every commitment of the chains is held against the plain
versions of msm_bucket, msm_merge and msm_wsum on its own scalars. The
toy chains compressed (RecursiveSNARK.compress) and verified, the Pasta
one byte-equal to the port's committed compressed proof of the reference's
chain where tests/data holds it
(tests/data/torch_toy_recursive_compressed.json.gz); the h_tables kernel
against its plain version and the host loop on rows of the toy primary.

Marked `cuda`: without a CUDA device each test skips (the decision is made
inside the fixture, never at import). On a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda_recursive.py -q -m cuda
"""

import contextlib
import copy
import gzip
import json
import os

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.core import blake3_ref as b3
from hotproofs_tpu_torch.models import chunk_prover as CP
from hotproofs_tpu_torch.nova import recursive as R
from hotproofs_tpu_torch.nova import spartan as SP
from hotproofs_tpu_torch.ops import curve as C
from hotproofs_tpu_torch.ops import msm_pallas as MP
from hotproofs_tpu_torch.ops import tables as TB
from spartan_chains import host_tables, small_key, sub_shape, table_test_rows
from test_torch_recursive_fixtures import (CHAINS, LABEL, Z0, compressed_path,
                                           load_ref, port_snark, ref_path,
                                           toy_host)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@contextlib.contextmanager
def commits_checked(counts: dict):
    """While active, every msm_many call runs its kernels and then their
    plain versions on the same digits, and must agree; counts['msm'] counts
    the calls."""
    msm_many = MP.msm_many

    def checked(spec, scalars, bases, m, max_bits, b=None, bases_lm=None):
        b, lpw, w4, _ = MP.plan(m, max_bits, b)
        d = MP.digits_tm(scalars, m, b, lpw, w4)
        bk = MP.msm_bucket(spec, d, bases, bases_lm)
        assert torch.equal(bk, MP.msm_bucket_plain(spec, d, bases))
        red = MP.msm_merge(spec, bk)
        assert torch.equal(red, MP.msm_merge_plain(spec, bk))
        s = MP.msm_wsum(spec, red)
        assert torch.equal(s, MP.msm_wsum_plain(spec, red))
        counts["msm"] = counts.get("msm", 0) + 1
        return msm_many(spec, scalars, bases, m, max_bits, b, bases_lm)

    MP.msm_many = checked
    try:
        yield
    finally:
        MP.msm_many = msm_many


@pytest.mark.parametrize("cycle,label", [
    (("pallas", "vesta"), LABEL),
    (("bn254", "grumpkin"), b"test-recursive-bn")], ids=["pasta", "bn254"])
def test_toy_chain_with_real_commits(dev, cycle, label):
    snark = port_snark(cycle, label, device=dev)
    counts: dict = {}
    before = MP.launches["msm_bucket"]
    with commits_checked(counts):
        proof = snark.prove(Z0, n_steps=CHAINS["toy"][1])
    assert MP.launches["msm_bucket"] > before and counts["msm"] >= 6
    z = Z0
    for _ in range(proof.n_steps):
        z = toy_host(snark.q)(z)
    assert snark.verify(proof) == z
    if cycle[0] == "pallas" and os.path.exists(ref_path("toy")):
        ref = load_ref("toy")
        assert json.dumps(proof.to_dict()) == json.dumps(ref)
        assert snark.verify(type(proof).from_dict(ref)) == z
    bad = type(proof).from_dict(proof.to_dict())
    bad.W2[3] = (bad.W2[3] + 1) % snark.p
    with pytest.raises(AssertionError, match="comm_W mismatch"):
        snark.verify(bad)


def test_chunk_prove_recursive_on_the_card(dev):
    prover = CP.ChunkProver(device=dev)
    data = bytes([7] * 10)
    counts: dict = {}
    with commits_checked(counts):
        root, proof = prover.prove_recursive(data, 0)
    assert root == b3.hash_bytes(data) and counts["msm"] == 3
    assert prover.verify_recursive(proof, expected_hash=root) == root
    proof.chunk_idx = 1
    with pytest.raises(AssertionError, match="z0 mismatch"):
        prover.verify_recursive(proof)


COMPRESSED_TOY = compressed_path()


@pytest.mark.parametrize("cycle,label", [
    (("pallas", "vesta"), LABEL),
    (("bn254", "grumpkin"), b"test-recursive-bn")], ids=["pasta", "bn254"])
def test_toy_chain_compressed(dev, cycle, label, tmp_path):
    """The toy chain proved, compressed and verified on the card; on Pasta
    the reference's proof compresses to the committed bytes; a changed
    argument of the strict claim is refused."""
    snark = port_snark(cycle, label, device=dev)
    proof = snark.prove(Z0, n_steps=CHAINS["toy"][1])
    before = MP.launches["h_tables"]
    snark.setup_compressed()
    assert MP.launches["h_tables"] - before in (0, 2)  # or the disk cache
    cp = snark.compress(proof)
    assert snark.verify_compressed(cp) == proof.z_final
    assert set(snark.compress_times) == {"sp1", "sp2", "sp_u1"}
    assert all(pt is None for pt in cp.sp_u1.ipa_E.Ls + cp.sp_u1.ipa_E.Rs)
    if cycle[0] == "pallas" and os.path.exists(COMPRESSED_TOY):
        mine = snark.compress(R.RecursiveProof.from_dict(load_ref("toy")))
        mine.save(str(tmp_path / "cp.json"))
        with gzip.open(COMPRESSED_TOY, "rt") as f, \
                open(tmp_path / "cp.json") as g:
            assert g.read() == f.read()
    bad = copy.deepcopy(cp)
    bad.sp_u1.ipa_L.Ls[2] = bad.sp_u1.ipa_L.Rs[2]
    with pytest.raises(AssertionError, match="IPA opening of L failed"):
        snark.verify_compressed(bad)


def test_h_tables_kernel_vs_plain_and_host(dev):
    """h_tables on the card == its plain version bit for bit (projective)
    and == the host loop (affine), on the toy primary's rows of
    tests/test_torch_tables.py over a 64-generator key."""
    from hotproofs_tpu_torch.circuits import gadgets as g
    from hotproofs_tpu_torch.circuits import nova_augmented as NA
    from hotproofs_tpu_torch.circuits.dsl import compile_circuit
    from hotproofs_tpu_torch.nova.r1cs import ShapeDevice
    from hotproofs_tpu_torch.ops import poseidon as P
    from test_torch_recursive_fixtures import toy_gadget
    c = NA.make_augmented_circuit(
        P.make_spec(C.PALLAS.scalar.name), C.VESTA.b, C.VESTA.scalar.p, 0,
        1, lambda ctx, z, e: toy_gadget(ctx, z, e, g), fold_at_base=True)
    r1cs, _ = compile_circuit(c, C.PALLAS.scalar.p)
    primary = ShapeDevice.from_dsl(r1cs)
    shape, _ = sub_shape(primary, table_test_rows(primary, 24), 64, dev)
    ck = small_key(C.PALLAS, b"tables-test", 64, dev)
    sps = SP.SpartanSystem(shape=shape, curve=C.PALLAS, ck=ck, pp_digest=1)
    csr = TB.table_csr(shape.field, [(d.rows, d.cols, d.vals) for d in (
        shape.dev[k] for k in "ABC")], sps.m)
    _, lpw, _, _ = MP.plan(sps.nz, 256)
    bl = ck.bases_lm(sps.nz, 256)
    before = MP.launches["h_tables"]
    got = TB.h_tables(C.PALLAS, csr, bl, lpw)
    assert MP.launches["h_tables"] == before + 1
    assert torch.equal(got, TB.h_tables_plain(C.PALLAS, csr, bl, lpw))
    want = host_tables(shape, ck, sps.m)
    assert all(np.array_equal(a, b) for a, b in zip(sps._build_H(), want))
