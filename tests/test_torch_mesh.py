"""The port's mesh (parallel/mesh.py, parallel/msm_sharded.py, the mesh
paths of nova/ivc.py and CommitmentKey.commit_many_mesh) in a real
two-process gloo group on the CPU: both ranks of tests/torch_mesh_worker.py
must agree, and equal the unsharded results computed here (affine points,
proof bytes); the segments the two ranks prove through my_segments and
checkpoint_dir compose and verify here (the reference's
tests/test_distributed.py, ported). On the card the mesh can only run as
one rank (one H100): tests/test_torch_cuda_chunk.py and chip_smoke.py
phase 12."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hotproofs_tpu_torch.nova.ivc import IVCProof
from hotproofs_tpu_torch.parallel import mesh as M
from hotproofs_tpu_torch.parallel.segments import (SegmentedProof,
                                                   verify_segments)
from torch_mesh_worker import (BIG, LOCK_CHAINS, N_POINTS, affine, key,
                               proof_text, scalars)
from torch_toy_chain import CONST, P, chain, toy_ivc

# pytest-xdist runs several workers on one host: one intra-op thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_worker.py")
REPO = os.path.dirname(os.path.dirname(WORKER))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (and the segment directory), from one run of
    the two worker processes."""
    tmp = tmp_path_factory.mktemp("mesh")
    seg_dir = str(tmp / "segments")
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, HOTPROOFS_COORDINATOR=f"127.0.0.1:{port}",
                   HOTPROOFS_NUM_PROCESSES="2",
                   HOTPROOFS_PROCESS_ID=str(rank), SEG_DIR=seg_dir,
                   OUT_DIR=str(tmp), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for rank, pr in enumerate(procs):
        try:
            out, err = pr.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p2 in procs:
                p2.kill()
            pytest.fail(f"rank {rank} timed out")
        outs.append((pr.returncode, out, err))
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"RANK_{rank}_OK" in out, \
            f"rank {rank} failed rc={rc}\n{err[-3000:]}"
    res = []
    for rank in range(2):
        with open(tmp / f"rank{rank}.json") as f:
            res.append(json.load(f))
    return res, seg_dir


@pytest.fixture(scope="module")
def toy():
    return toy_ivc()


def _agree(ranks, name):
    res, _ = ranks
    assert res[0][name] == res[1][name], f"ranks disagree on {name}"
    return res[0][name]


def test_msm_sharded_equals_msm_many(ranks):
    ck = key()
    sc = scalars(np.random.default_rng(11), (2, N_POINTS), 256)
    want = affine(ck, ck.commit_many(sc, 256))
    assert N_POINTS % 2 == 1
    assert _agree(ranks, "msm_sharded") == want
    assert _agree(ranks, "msm_sharded_bases") == want[1:]


def test_batch_commits_on_the_mesh_equal_commit_many(ranks):
    ck = key()
    rng = np.random.default_rng(11)
    sc = scalars(rng, (2, N_POINTS), 256)
    small = scalars(rng, (4, N_POINTS), 40)
    assert _agree(ranks, "batch_commit_sharded") == \
        affine(ck, ck.commit_many(small, 40))
    assert _agree(ranks, "commit_many_mesh") == \
        affine(ck, ck.commit_many(torch.cat([sc, sc.flip(0)]), 256))
    mixed = small.clone()
    mixed[:, BIG] = sc[0, :len(BIG)]
    assert _agree(ranks, "commit_many_mesh_split") == \
        affine(ck, ck.commit_many_split(mixed, np.asarray(BIG)))


@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_prove_batch_on_the_mesh_is_byte_equal(ranks, toy, shape):
    ivc, _, layout = toy
    canon, X, _ = chain(layout, 3, 5)
    want = proof_text(ivc.prove_batch([3], canon, X, chunk_steps=2))
    assert _agree(ranks, f"prove_batch_{shape}") == want


@pytest.mark.parametrize("K", [2, 4])
def test_prove_lockstep_on_the_mesh_equals_separate_chains(ranks, toy, K):
    ivc, _, layout = toy
    want = []
    for z0, n in LOCK_CHAINS[:K]:
        canon, X, _ = chain(layout, z0, n)
        want.append(proof_text(ivc.prove_batch([z0], canon, X)))
    assert _agree(ranks, f"prove_lockstep_{K}") == want


def test_make_mesh_refuses_a_wrong_size(ranks):
    assert _agree(ranks, "make_mesh_2x3") == "mesh 2x3 != 2 devices"


def test_two_process_segments_compose_and_verify(ranks, toy):
    """Each rank proved segments [rank::2] of one 8-step chain into the
    checkpoint directory; their union composes and verifies here."""
    _, seg_dir = ranks
    ivc, _, _ = toy
    files = sorted(os.listdir(seg_dir))
    assert len(files) == 4, files
    proof = SegmentedProof(segments=[
        IVCProof.load(os.path.join(seg_dir, f)) for f in files])
    z = 3
    for _ in range(8):
        z = (pow(z, 3, P) + CONST) % P
    assert verify_segments(ivc, proof, io_arity=1) == [z]


def test_init_distributed_without_environment_is_a_no_op(monkeypatch):
    for name in ("HOTPROOFS_COORDINATOR", "HOTPROOFS_NUM_PROCESSES",
                 "HOTPROOFS_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert M.init_distributed() == 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        M.make_mesh(1, 1, device="cpu")


def test_cuda_mesh_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh(1, 1, device="cuda")
