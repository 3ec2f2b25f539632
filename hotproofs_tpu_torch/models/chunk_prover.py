"""Prove and verify possession of a BLAKE3 chunk by Nova folding (port of
hotproofs_tpu/models/chunk_prover.py: prove, prove_many, verify, the CLI).

One step per 64-byte block of the chunk plus one per Merkle level; the
verifier recomputes the root hash from the final state z[2:10]. Proofs are
the reference's JSON format, byte for byte.

Usage (CLI):
    python -m hotproofs_tpu_torch.models.chunk_prover prove --file F \
        --chunk 0 --out proof.json [--device cuda|cpu]
    python -m hotproofs_tpu_torch.models.chunk_prover verify \
        --proof proof.json --expect-hash HEX [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..circuits import blake3_nova as nova_circ
from ..circuits import witness_torch as WT
from ..core import blake3_ref as b3
from ..core import native
from ..nova import serial
from ..nova.ivc import IVC, IVCProof, check
from ..nova.pedersen import CommitmentKey
from ..nova.r1cs import ShapeDevice
from ..ops import curve as C
from ..ops import field as F
from ..utils.config import require_device

IO_ARITY = nova_circ.IO_ARITY
NOT_PORTED = "not ported yet, see ROADMAP.md"


def _big_witness_indices(layout, n_io: int) -> np.ndarray:
    """Witness positions holding full-width field elements: the IsZero
    inverse hints. Everything else in the step witness is < 2^40."""
    idx = []
    w_base = 1 + n_io
    for seg in layout.segments:
        if seg.role == "aux" and seg.name.endswith("/inv"):
            idx.extend(seg.start + k - w_base for k in range(seg.length))
    return np.asarray(sorted(idx), dtype=np.int64)


@lru_cache(maxsize=None)
def _build_stack(curve_name: str, depth_bits: int, device: str):
    curve = C.CURVES[curve_name]
    modulus = curve.scalar.p
    r1cs, layout = nova_circ.get_nova_step_circuit(modulus, 0, depth_bits)
    shape = ShapeDevice.from_dsl(r1cs, device)
    # Power-of-two key size, as the reference (the pp digest hashes it).
    n = max(shape.n_wit, shape.n_cons)
    n = 1 << (n - 1).bit_length()
    ck = CommitmentKey.create(curve, b"blake3-nova", n, device)
    label = b"blake3-chunk" if depth_bits == 8 \
        else b"blake3-chunk-d%d" % depth_bits
    ivc = IVC(shape, curve, ck, _big_witness_indices(layout, shape.n_io),
              label=label)
    return ivc, layout, modulus


@dataclass
class ChunkProof:
    """Proof + public statement."""

    ivc_proof: IVCProof
    chunk_idx: int
    n_blocks: int
    leaf_depth: int
    total_depth: int

    def to_dict(self) -> dict:
        return {"ivc_proof": self.ivc_proof.to_dict(),
                "chunk_idx": int(self.chunk_idx),
                "n_blocks": int(self.n_blocks),
                "leaf_depth": int(self.leaf_depth),
                "total_depth": int(self.total_depth)}

    def save(self, path: str) -> None:
        serial.dump("chunk_proof", self.to_dict(), path)

    @staticmethod
    def load(path: str) -> "ChunkProof":
        d = serial.load("chunk_proof", path)
        return ChunkProof(
            ivc_proof=IVCProof.from_dict(d["ivc_proof"]),
            chunk_idx=int(d["chunk_idx"]), n_blocks=int(d["n_blocks"]),
            leaf_depth=int(d["leaf_depth"]),
            total_depth=int(d["total_depth"]))


def check_statement(modulus: int, z0, num_steps, chunk_idx, n_blocks,
                    leaf_depth, total_depth) -> None:
    """z0 must encode (IV, depth = leaf_depth - 1, block_count = 0, the
    claimed chunk index); the step count must match the schedule."""
    expected_z0 = ([n_blocks, 0] + list(b3.IV)
                   + [total_depth, leaf_depth - 1, chunk_idx & 0xFFFFFFFF,
                      chunk_idx >> 32, leaf_depth])
    check([v % modulus for v in z0] == [v % modulus for v in expected_z0],
          "z0 mismatch")
    check(num_steps == n_blocks + leaf_depth - 1, "step count")


def check_final(z_final, n_blocks, expected_hash: Optional[bytes],
                chunk_idx: Optional[int] = None,
                leaf_depth: Optional[int] = None,
                total_depth: Optional[int] = None) -> bytes:
    """All blocks absorbed, root reached; the hash is z[2:10] as LE words.
    The statement fields the circuit carries through must be unchanged."""
    check(z_final[0] == n_blocks, "n_blocks drifted")
    check(z_final[1] == n_blocks, "not all blocks absorbed")
    check(z_final[11] == 0, "did not reach the root")
    if total_depth is not None:
        check(z_final[10] == total_depth, "total_depth drifted")
    if chunk_idx is not None:
        check(z_final[12] == chunk_idx & 0xFFFFFFFF, "chunk_idx low drifted")
        check(z_final[13] == chunk_idx >> 32, "chunk_idx high drifted")
    if leaf_depth is not None:
        check(z_final[14] == leaf_depth, "leaf_depth drifted")
    root = b"".join(int(w).to_bytes(4, "little") for w in z_final[2:10])
    if expected_hash is not None:
        check(root == expected_hash, "root hash mismatch")
    return root


class ChunkProver:
    """prove/verify pair for BLAKE3 chunk possession on one device (the
    card unless device='cpu')."""

    def __init__(self, curve: str = "pallas", depth_bits: int = 8,
                 device="cuda"):
        self.depth_bits = depth_bits
        self.device = require_device(device)
        self.ivc, self.layout, self.modulus = _build_stack(
            curve, depth_bits, str(self.device))

    @staticmethod
    def _hash_with_path(data: bytes, chunk_idx: int):
        """The native tree hasher when it builds, the Python oracle
        otherwise."""
        pd = native.hash_with_path(data, chunk_idx) \
            if native.get_lib() is not None else None
        return pd if pd is not None else b3.hash_with_path(data, chunk_idx)

    def _witness_slice_canon(self, zs, sched, a: int, b: int):
        """Step witnesses [a, b) of a precomputed chain, generated on the
        device and expanded to canonical digits (b - a, n_vars, 32) with
        the full-width inverse hints patched."""
        dev = self.device
        tens = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
        steps = sched.steps[a:b]
        w_u32 = WT.batched_nova_witness(
            tens(zs[a:b]), tens([s.m for s in steps]),
            tens([s.b for s in steps]), tens([s.down_left for s in steps]),
            0, self.depth_bits)
        inv = np.zeros((b - a, 3, F.N_LIMBS), np.int32)
        for i, z in enumerate(zs[a:b]):
            for j, v in enumerate(WT.nova_inverse_values(
                    z[11], z[1], z[0], self.modulus)):
                inv[i, j] = F.int_to_limbs(v)
        return WT.witness_canon(
            w_u32, WT.nova_big_positions(self.modulus, self.depth_bits),
            torch.from_numpy(inv))

    def _device_witness_chain(self, proof_data):
        zs, sched = nova_circ.z_chain(proof_data, self.modulus)
        n = len(sched.steps)
        canon = self._witness_slice_canon(zs, sched, 0, n)
        X_host = [list(zs[i + 1]) + list(zs[i]) for i in range(n)]
        return zs, sched, canon, X_host

    def _chunk_proof(self, proof_data, sched, ci, ivc_proof) -> ChunkProof:
        return ChunkProof(ivc_proof=ivc_proof, chunk_idx=ci,
                          n_blocks=sched.n_blocks,
                          leaf_depth=sched.leaf_depth,
                          total_depth=proof_data.total_depth)

    def prove(self, data: bytes, chunk_idx: int,
              progress: bool = False) -> Tuple[bytes, ChunkProof]:
        proof_data = self._hash_with_path(data, chunk_idx)
        _, sched, canon, X_host = self._device_witness_chain(proof_data)
        ivc_proof = self.ivc.prove_batch(sched.z0, canon, X_host,
                                         progress=progress)
        return proof_data.root_hash, self._chunk_proof(
            proof_data, sched, chunk_idx, ivc_proof)

    def prove_many(self, data: bytes, chunk_idxs: Sequence[int],
                   progress: bool = False) -> Tuple[bytes, List[ChunkProof]]:
        """Prove several chunks of one file as K lockstep fold chains; each
        proof is bit-identical to a standalone prove(data, idx)."""
        chains, metas = [], []
        for ci in chunk_idxs:
            proof_data = self._hash_with_path(data, ci)
            _, sched, canon, X_host = self._device_witness_chain(proof_data)
            chains.append((sched.z0, canon, X_host))
            metas.append((proof_data, sched, ci))
        ivc_proofs = self.ivc.prove_lockstep(chains, progress=progress)
        return metas[0][0].root_hash, [
            self._chunk_proof(pd, sched, ci, p)
            for (pd, sched, ci), p in zip(metas, ivc_proofs)]

    def verify(self, proof: ChunkProof,
               expected_hash: Optional[bytes] = None) -> bytes:
        """Verify the fold chain and statement; returns the proven root."""
        check_statement(self.modulus, proof.ivc_proof.z0,
                        proof.ivc_proof.num_steps, proof.chunk_idx,
                        proof.n_blocks, proof.leaf_depth, proof.total_depth)
        z_final = self.ivc.verify(proof.ivc_proof, io_arity=IO_ARITY)
        return check_final(z_final, proof.n_blocks, expected_hash,
                           chunk_idx=proof.chunk_idx,
                           leaf_depth=proof.leaf_depth,
                           total_depth=proof.total_depth)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("prove")
    p1.add_argument("--file", required=True)
    p1.add_argument("--chunk", type=int, default=0)
    p1.add_argument("--out", default="proof.json")
    p1.add_argument("--compress", action="store_true",
                    help=f"compressed proof (Spartan): {NOT_PORTED}")
    p1.add_argument("--device", default="cuda",
                    help="torch device (default: %(default)s)")
    p2 = sub.add_parser("verify")
    p2.add_argument("--proof", required=True)
    p2.add_argument("--expect-hash", default=None)
    p2.add_argument("--vk", default=None,
                    help=f"verify from an exported vk: {NOT_PORTED}")
    p2.add_argument("--device", default="cuda",
                    help="torch device (default: %(default)s)")
    sub.add_parser("export-vk", help=NOT_PORTED)
    args = ap.parse_args(argv)

    if args.cmd == "export-vk" or getattr(args, "compress", False) or \
            getattr(args, "vk", None):
        sys.exit(f"{args.cmd}: this option is {NOT_PORTED}")

    prover = ChunkProver(device=args.device)
    if args.cmd == "prove":
        with open(args.file, "rb") as f:
            data = f.read()
        t0 = time.time()
        root, proof = prover.prove(data, args.chunk, progress=True)
        dt = time.time() - t0
        n = proof.ivc_proof.num_steps
        print(f"root hash: {root.hex()}")
        print(f"steps: {n}  time: {dt:.2f}s  folds/sec: {n / dt:.3f}")
        proof.save(args.out)
        print(f"proof written to {args.out}")
    else:
        expect = bytes.fromhex(args.expect_hash) if args.expect_hash else None
        t0 = time.time()
        proof = ChunkProof.load(args.proof)
        root = prover.verify(proof, expect)
        print(f"VERIFIED root hash: {root.hex()}  "
              f"({time.time() - t0:.2f}s, {proof.ivc_proof.num_steps} steps)")


if __name__ == "__main__":
    main()
