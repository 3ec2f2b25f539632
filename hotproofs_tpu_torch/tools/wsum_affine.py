"""msm_wsum and to_affine against their plain versions, timed on the card.

    python -m hotproofs_tpu_torch.tools.wsum_affine [--device cuda] [--seed 0]

msm_wsum at the slot and job counts the prover's commits give it (S = 15:
comm_T of one chain, J = 1, and of prove_many K = 2, J = 2; the W commits
of one chunk, J = 16, and of K = 16 chains, J = 256; S = 8, the signed
digits' slots, at J = 1), and to_affine at the blake3-nova key's
1,034,368 points (64 windows of 16,162 generators) and at 4,096 points,
one block of the kernel (ops/msm_pallas.py AFFINE_BLOCK), whose time is
the latency of one Fermat chain. The inputs are seeded random field
elements below 2^254 as projective coordinates, a tenth of the slots the
identity and a tenth of the Z's zero: the formulas are total, and the
kernels' time depends on the data only through those. Each kernel is held
against its plain version first (exact), then timed: CUDA-event mean of
REPS calls after that first call. One line a shape, a JSON line last.

The functions are importable; they reach the kernels only through the
wrappers of ops/msm_pallas.py, so the same file times an older tree's
kernels.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm_pallas as MP
from ..utils.config import require_device
from .msm_designs import timer

SPEC = C.PALLAS
NW = 8
WSUM_SHAPES: Dict[str, Tuple[int, int]] = {    # tag -> (J, S)
    "comm_T J=1": (1, 15), "comm_T J=2": (2, 15), "W J=16": (16, 15),
    "W J=256": (256, 15), "signed J=1": (1, 8)}
AFFINE_SHAPES: Dict[str, int] = {"blake3-nova key": 64 * 16162,
                                 "one block": 4096}
EMPTY = 0.1             # share of identity slots and of zero Z's
REPS = 5


def random_words(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """(*shape, 8) int32 words of seeded field elements below 2^254 (< p
    for both Pasta fields)."""
    w = rng.integers(0, 1 << 32, size=(*shape, NW), dtype=np.uint32)
    w[..., 7] &= 0x3FFFFFFF
    return torch.from_numpy(w.view(np.int32)).to(device)


def random_reduced(rng: np.random.Generator, J: int, S: int,
                   device) -> torch.Tensor:
    """(J, S, 3, 8) projective slots, a share EMPTY of them the identity
    (0 : 1 : 0)."""
    red = random_words(rng, (J, S, 3), device)
    empty = torch.from_numpy(rng.random((J, S)) < EMPTY).to(device)
    one = F.digits_to_words(torch.from_numpy(
        SPEC.base.one_mont_limbs).to(device))
    red[empty] = torch.stack([torch.zeros_like(one), one,
                              torch.zeros_like(one)])
    return red


def random_projective(rng: np.random.Generator, n: int, device):
    """X, Y, Z (n, 8) words, a share EMPTY of the Z's zero."""
    X, Y, Z = random_words(rng, (3, n), device).unbind(0)
    Z = Z.clone()
    Z[torch.from_numpy(rng.random(n) < EMPTY).to(device)] = 0
    return X.contiguous(), Y.contiguous(), Z


def run(device: torch.device, rng: np.random.Generator, reps: int = REPS,
        wsum_shapes=None, affine_shapes=None, out=print) -> Dict[str, dict]:
    """Check and time every shape; pass one line a shape to out. Returns
    {"msm_wsum": {tag: {...}}, "to_affine": {tag: {...}}}."""
    ms = timer(device)
    res: Dict[str, dict] = {"msm_wsum": {}, "to_affine": {}}
    for tag, (J, S) in (wsum_shapes or WSUM_SHAPES).items():
        red = random_reduced(rng, J, S, device)
        ok = torch.equal(MP.msm_wsum(SPEC, red),
                         MP.msm_wsum_plain(SPEC, red))
        t = ms(lambda: MP.msm_wsum(SPEC, red), reps)
        res["msm_wsum"][tag] = {"J": J, "S": S, "ms": t, "ok": ok}
        out(f"msm_wsum {tag} (J={J}, S={S}): {t:.4f} ms, == plain "
            f"{'OK' if ok else 'FAILED'}")
    for tag, n in (affine_shapes or AFFINE_SHAPES).items():
        X, Y, Z = random_projective(rng, n, device)
        got = MP.to_affine_words(SPEC, X, Y, Z)
        want = MP.to_affine_words_plain(SPEC, X, Y, Z)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        t = ms(lambda: MP.to_affine_words(SPEC, X, Y, Z), reps)
        res["to_affine"][tag] = {"n": n, "ms": t, "ok": ok}
        out(f"to_affine {tag} ({n} points): {t:.4f} ms, == plain "
            f"{'OK' if ok else 'FAILED'}")
        del X, Y, Z, got, want
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def all_ok(res: Dict[str, dict]) -> bool:
    return all(d["ok"] for part in res.values() for d in part.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: %(default)s)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {dev}: {name}", flush=True)
    res = run(dev, np.random.default_rng(args.seed),
              out=lambda line: print(line, flush=True))
    print(json.dumps(res))
    return 0 if all_ok(res) else 1


if __name__ == "__main__":
    raise SystemExit(main())
