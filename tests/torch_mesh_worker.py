"""One rank of the port's two-process mesh checks on the CPU (gloo);
tests/test_torch_mesh.py starts two of them with HOTPROOFS_COORDINATOR,
HOTPROOFS_NUM_PROCESSES and HOTPROOFS_PROCESS_ID set and compares what
they write to OUT_DIR/rank{r}.json with the unsharded results:

  * msm_sharded over "msm" (N = 37, no multiple of 2; a key and bare
    bases), batch_commit_sharded over "step", commit_many_mesh over
    "chain" (plain and split), as affine points;
  * prove_batch of a 5-step toy chain on a 1x2 and a 2x1 mesh;
  * prove_lockstep on a 2-rank chain mesh at K = 2 and K = 4;
  * make_mesh(2, 3) refused;
  * segments [rank::2] of an 8-step chain proved through my_segments into
    SEG_DIR (the parent composes and verifies them).
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hotproofs_tpu_torch.nova.pedersen import CommitmentKey  # noqa: E402
from hotproofs_tpu_torch.ops import curve as C  # noqa: E402
from hotproofs_tpu_torch.parallel import mesh as M  # noqa: E402
from hotproofs_tpu_torch.parallel.msm_sharded import (  # noqa: E402
    batch_commit_sharded, msm_sharded)
from hotproofs_tpu_torch.parallel.segments import prove_segments  # noqa
from torch_toy_chain import chain, toy_gens, toy_ivc  # noqa: E402

torch.set_num_threads(1)
N_POINTS, BIG = 37, [1, 5, 30]
LOCK_CHAINS = [(4, 3), (9, 2), (11, 4), (2, 1)]     # (z0, steps)


def scalars(rng, shape, bits):
    """Seeded canonical digits below 2^bits (and below the group order)."""
    raw = rng.integers(0, 256, size=shape + (32,), dtype=np.int64)
    raw[..., (bits + 7) // 8:] = 0
    raw[..., 31] &= 0x3F
    return torch.from_numpy(raw.astype(np.int32))


def key():
    """A label-less key (no disk cache) over the b"toy" generators."""
    return CommitmentKey(C.PALLAS, N_POINTS, toy_gens(N_POINTS), b"")


def affine(ck, pt):
    return [list(p) if p is not None else None for p in ck.affine(pt)]


def proof_text(p):
    return json.dumps(p.to_dict())


def main():
    rank = M.init_distributed(device="cpu")
    assert torch.distributed.get_world_size() == 2
    out = {"rank": rank}
    rng = np.random.default_rng(11)
    ck = key()
    sc = scalars(rng, (2, N_POINTS), 256)
    m12 = M.make_mesh(1, 2, device="cpu")
    m21 = M.make_mesh(2, 1, device="cpu")
    chains = M.make_chain_mesh(device="cpu")
    out["msm_sharded"] = affine(ck, msm_sharded(ck, m12, sc))
    xa, ya = ck.scaled_affine(N_POINTS, 256)
    one = msm_sharded((C.PALLAS, xa, ya), m12, sc[1])
    out["msm_sharded_bases"] = affine(ck, tuple(c[None] for c in one))
    small = scalars(rng, (4, N_POINTS), 40)
    out["batch_commit_sharded"] = affine(
        ck, batch_commit_sharded(ck, m21, small, 40))
    out["commit_many_mesh"] = affine(
        ck, ck.commit_many_mesh(torch.cat([sc, sc.flip(0)]), chains))
    mixed = small.clone()
    mixed[:, BIG] = sc[0, :len(BIG)]
    out["commit_many_mesh_split"] = affine(
        ck, ck.commit_many_mesh(mixed, chains, big_idx=np.asarray(BIG)))
    try:
        M.make_mesh(2, 3, device="cpu")
        out["make_mesh_2x3"] = None
    except AssertionError as e:
        out["make_mesh_2x3"] = str(e)

    ivc, _, layout = toy_ivc()
    canon, X, _ = chain(layout, 3, 5)
    out["prove_batch_1x2"] = proof_text(ivc.prove_batch(
        [3], canon, X, chunk_steps=2, mesh=m12))
    out["prove_batch_2x1"] = proof_text(ivc.prove_batch(
        [3], canon, X, chunk_steps=2, mesh=m21))
    lock = [([z0],) + chain(layout, z0, n)[:2] for z0, n in LOCK_CHAINS]
    for K in (2, 4):
        out[f"prove_lockstep_{K}"] = [proof_text(p) for p in
                                      ivc.prove_lockstep(lock[:K], 2,
                                                         mesh=chains)]

    canon8, X8, _ = chain(layout, 3, 8)
    zs = [[3]]
    for x in X8:
        zs.append([x[0]])
    prove_segments(ivc, zs, canon8, X8, n_segments=4,
                   my_segments=list(range(rank, 4, 2)),
                   checkpoint_dir=os.environ["SEG_DIR"])
    torch.distributed.destroy_process_group()
    with open(os.path.join(os.environ["OUT_DIR"], f"rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
    print(f"RANK_{rank}_OK", flush=True)


if __name__ == "__main__":
    main()
