"""Prove and verify possession of a BLAKE3 chunk by Nova folding (port of
hotproofs_tpu/models/chunk_prover.py: prove (batched, per-step, or on a
mesh), prove_many, verify, the verification key, segmented proofs,
compressed proofs, recursive proofs, the CLI).

One step per 64-byte block of the chunk plus one per Merkle level; the
verifier recomputes the root hash from the final state z[2:10]. Proofs and
verification keys are the reference's JSON formats, byte for byte.

Usage (CLI):
    python -m hotproofs_tpu_torch.models.chunk_prover prove --file F \
        --chunk 0 --out proof.json [--compress] [--device cuda|cpu]
    python -m hotproofs_tpu_torch.models.chunk_prover verify \
        --proof proof.json --expect-hash HEX [--vk vk.json] \
        [--device cuda|cpu]
    python -m hotproofs_tpu_torch.models.chunk_prover export-vk \
        --out vk.json [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
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
from ..nova.recursive import RecursiveProof, RecursiveSNARK
from ..nova.spartan import CompressedProof, SpartanSystem
from ..nova.vk import export_vk, ivc_from_vk
from ..ops import curve as C
from ..ops import field as F
from ..parallel.segments import (SegmentedProof, prove_segments,
                                 verify_segments)
from ..utils.config import require_device

IO_ARITY = nova_circ.IO_ARITY


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


@dataclass
class CompressedChunkProof:
    """Succinct proof + public statement: the chain's per-step instances
    plus a Spartan argument, no accumulator witness vectors
    (nova/spartan.py)."""

    compressed: CompressedProof
    chunk_idx: int
    n_blocks: int
    leaf_depth: int
    total_depth: int

    def save(self, path: str) -> None:
        serial.dump("compressed_chunk_proof", {
            "compressed": self.compressed.to_dict(),
            "chunk_idx": int(self.chunk_idx),
            "n_blocks": int(self.n_blocks),
            "leaf_depth": int(self.leaf_depth),
            "total_depth": int(self.total_depth),
        }, path)

    @staticmethod
    def load(path: str) -> "CompressedChunkProof":
        d = serial.load("compressed_chunk_proof", path)
        return CompressedChunkProof(
            compressed=CompressedProof.from_dict(d["compressed"]),
            chunk_idx=int(d["chunk_idx"]), n_blocks=int(d["n_blocks"]),
            leaf_depth=int(d["leaf_depth"]),
            total_depth=int(d["total_depth"]))


@dataclass
class SegmentedChunkProof:
    """Chunk statement + a segment-parallel fold proof
    (parallel/segments.SegmentedProof)."""

    segmented: SegmentedProof
    chunk_idx: int
    n_blocks: int
    leaf_depth: int
    total_depth: int

    def to_dict(self) -> dict:
        return {"segmented": self.segmented.to_dict(),
                "chunk_idx": int(self.chunk_idx),
                "n_blocks": int(self.n_blocks),
                "leaf_depth": int(self.leaf_depth),
                "total_depth": int(self.total_depth)}

    def save(self, path: str) -> None:
        serial.dump("segmented_chunk_proof", self.to_dict(), path)

    @staticmethod
    def load(path: str) -> "SegmentedChunkProof":
        d = serial.load("segmented_chunk_proof", path)
        return SegmentedChunkProof(
            segmented=SegmentedProof.from_dict(d["segmented"]),
            chunk_idx=int(d["chunk_idx"]), n_blocks=int(d["n_blocks"]),
            leaf_depth=int(d["leaf_depth"]),
            total_depth=int(d["total_depth"]))


@dataclass
class RecursiveChunkProof:
    """Chunk statement + an augmented-IVC proof (nova/recursive.py): its
    verification work does not grow with the chain."""

    rec: RecursiveProof
    chunk_idx: int
    n_blocks: int
    leaf_depth: int
    total_depth: int

    def save(self, path: str) -> None:
        serial.dump("recursive_chunk_proof", {
            "rec": self.rec.to_dict(),
            "chunk_idx": int(self.chunk_idx),
            "n_blocks": int(self.n_blocks),
            "leaf_depth": int(self.leaf_depth),
            "total_depth": int(self.total_depth),
        }, path)

    @staticmethod
    def load(path: str) -> "RecursiveChunkProof":
        d = serial.load("recursive_chunk_proof", path)
        return RecursiveChunkProof(
            rec=RecursiveProof.from_dict(d["rec"]),
            chunk_idx=int(d["chunk_idx"]), n_blocks=int(d["n_blocks"]),
            leaf_depth=int(d["leaf_depth"]),
            total_depth=int(d["total_depth"]))


# The recursive SNARK's 2-cycle, by the prover's curve.
CYCLES = {"pallas": (C.PALLAS, C.VESTA), "vesta": (C.VESTA, C.PALLAS),
          "bn254": (C.BN254, C.GRUMPKIN), "grumpkin": (C.GRUMPKIN, C.BN254)}


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


def _proof_root(z_final, proof, expected_hash: Optional[bytes]) -> bytes:
    """check_final against a chunk proof's statement fields."""
    return check_final(z_final, proof.n_blocks, expected_hash,
                       chunk_idx=proof.chunk_idx,
                       leaf_depth=proof.leaf_depth,
                       total_depth=proof.total_depth)


def verify_with_vk(vk_path: str, proof: ChunkProof,
                   expected_hash: Optional[bytes] = None,
                   device="cuda") -> bytes:
    """Verify a chunk proof from an exported verification key alone (the
    circuit DSL and the witness code are never built); returns the root."""
    ivc = ivc_from_vk(vk_path, device)
    check_statement(ivc.shape.field.p, proof.ivc_proof.z0,
                    proof.ivc_proof.num_steps, proof.chunk_idx,
                    proof.n_blocks, proof.leaf_depth, proof.total_depth)
    return _proof_root(ivc.verify(proof.ivc_proof, io_arity=IO_ARITY),
                       proof, expected_hash)


class ChunkProver:
    """prove/verify pair for BLAKE3 chunk possession on one device (the
    card unless device='cpu')."""

    def __init__(self, curve: str = "pallas", depth_bits: int = 8,
                 device="cuda"):
        """depth_bits widens the circuit's depth decompositions past 8 bits
        (tree depth 255): 13 admits 4,096-step chains
        (tools/longchain_deep.py). Each (curve, depth_bits) is its own
        circuit with its own pp digest."""
        self.depth_bits = depth_bits
        self.device = require_device(device)
        self.ivc, self.layout, self.modulus = _build_stack(
            curve, depth_bits, str(self.device))
        self._spartan: Optional[SpartanSystem] = None
        self._recursive: Optional[RecursiveSNARK] = None

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

    def _host_witness_chain(self, proof_data, slice_steps: int = 512):
        """Like _device_witness_chain, but canon is host numpy, generated
        on the device in slices of slice_steps: a 4,096-step chain's digits
        (about 8.4 GB) stay off the card beside the fold's state, and the
        prover uploads one chunk of steps at a time."""
        zs, sched = nova_circ.z_chain(proof_data, self.modulus)
        n = len(sched.steps)
        canon = np.empty((n, self.ivc.shape.n_vars, F.N_LIMBS), np.int32)
        for a in range(0, n, slice_steps):
            b = min(n, a + slice_steps)
            canon[a:b] = self._witness_slice_canon(zs, sched, a,
                                                b).cpu().numpy()
        X_host = [list(zs[i + 1]) + list(zs[i]) for i in range(n)]
        return zs, sched, canon, X_host

    def _chunk_proof(self, proof_data, sched, ci, ivc_proof) -> ChunkProof:
        return ChunkProof(ivc_proof=ivc_proof, chunk_idx=ci,
                          n_blocks=sched.n_blocks,
                          leaf_depth=sched.leaf_depth,
                          total_depth=proof_data.total_depth)

    def prove(self, data: bytes, chunk_idx: int, progress: bool = False,
              fast: bool = True, mesh=None) -> Tuple[bytes, ChunkProof]:
        """Prove chunk_idx of data; returns (root_hash, ChunkProof).

        fast: the batched path (the chain's witnesses in one device batch,
        IVC.prove_batch, on the mesh if one is given: parallel/mesh.py);
        fast=False: the per-step host path (_prove_host), the reference's
        cross-check, with the same bytes."""
        proof_data = self._hash_with_path(data, chunk_idx)
        if fast:
            _, sched, canon, X_host = self._device_witness_chain(proof_data)
            ivc_proof = self.ivc.prove_batch(sched.z0, canon, X_host,
                                             progress=progress, mesh=mesh)
        else:
            check(mesh is None, "the per-step path runs on one device")
            sched, ivc_proof = self._prove_host(proof_data, progress)
        return proof_data.root_hash, self._chunk_proof(
            proof_data, sched, chunk_idx, ivc_proof)

    def _prove_host(self, proof_data, progress: bool):
        """The per-step path: each step's witness evaluated on the host
        from the schedule and folded by IVC.prove as it comes (its
        per-step ms are left in self.ivc.timings)."""
        sched = nova_circ.build_schedule(proof_data)

        def witnesses():
            z = [v % self.modulus for v in sched.z0]
            for step in sched.steps:
                w, z = nova_circ.eval_step_witness(
                    z, step, self.modulus, depth_bits=self.depth_bits)
                yield w

        return sched, self.ivc.prove(sched.z0, witnesses(),
                                     progress=progress)

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

    def prove_segmented(self, data: bytes, chunk_idx: int,
                        n_segments: int, devices=None,
                        progress: bool = False
                        ) -> Tuple[bytes, SegmentedChunkProof]:
        """Prove a chunk as n_segments independent fold chains composed by
        public-IO chaining (parallel/segments.py). On the prover's own
        device the segments fold together (the lockstep path); with a
        devices list each is proved on its device of the list (the thread
        pool). Both paths give the same bytes."""
        proof_data = self._hash_with_path(data, chunk_idx)
        zs, sched, canon, X_host = self._device_witness_chain(proof_data)
        seg = prove_segments(self.ivc, zs, canon, X_host, n_segments,
                             devices=devices, lockstep=devices is None,
                             progress=progress)
        return proof_data.root_hash, SegmentedChunkProof(
            segmented=seg, chunk_idx=chunk_idx, n_blocks=sched.n_blocks,
            leaf_depth=sched.leaf_depth, total_depth=proof_data.total_depth)

    @property
    def spartan(self) -> SpartanSystem:
        """The Spartan compression system of this circuit and key, built on
        first use (its matrix tables come from the disk cache when it holds
        them for this pp digest)."""
        if self._spartan is None:
            self._spartan = SpartanSystem(self.ivc)
        return self._spartan

    def compress(self, proof: ChunkProof) -> CompressedChunkProof:
        """Compress a chunk proof: drop the accumulator witness, attach the
        Spartan argument."""
        cp = self.spartan.compress(proof.ivc_proof, io_arity=IO_ARITY)
        return CompressedChunkProof(
            compressed=cp, chunk_idx=proof.chunk_idx,
            n_blocks=proof.n_blocks, leaf_depth=proof.leaf_depth,
            total_depth=proof.total_depth)

    @property
    def recursive(self) -> RecursiveSNARK:
        """The RecursiveSNARK with the BLAKE3 step as F (the augmented IVC),
        built on first use on the prover's cycle: Pasta, or BN254/Grumpkin
        for ChunkProver(curve="bn254"). Its keys are made on its first
        commit."""
        if self._recursive is None:
            def f_gadget(ctx, z_prev, extra):
                return nova_circ.nova_step_body(ctx, z_prev, extra, 0,
                                                self.depth_bits)

            def f_host(z, extra):
                step = nova_circ.StepInputs(
                    m=tuple(extra["m"]), b=int(extra["b"][0]),
                    down_left=int(extra["down_left"][0]))
                _, z_out = nova_circ.eval_step_witness(
                    z, step, self.modulus, depth_bits=self.depth_bits)
                return z_out

            self._recursive = RecursiveSNARK(
                f_gadget, f_host, arity=IO_ARITY, label=b"blake3-rec",
                f_extra_decl=nova_circ.declare_step_inputs,
                cycle=CYCLES[self.ivc.curve.name], device=self.device)
        return self._recursive

    def prove_recursive(self, data: bytes, chunk_idx: int,
                        progress: bool = False
                        ) -> Tuple[bytes, RecursiveChunkProof]:
        """Prove a chunk by the augmented recursive IVC: each step verifies
        the other curve's fold in-circuit, and the verifier's work does not
        grow with the chain. Returns (root_hash, RecursiveChunkProof)."""
        proof_data = self._hash_with_path(data, chunk_idx)
        sched = nova_circ.build_schedule(proof_data)
        step_inputs = [{"m": list(s.m), "b": [s.b],
                        "down_left": [s.down_left]} for s in sched.steps]
        rproof = self.recursive.prove(sched.z0, len(sched.steps),
                                      step_inputs=step_inputs,
                                      progress=progress)
        # The statement comes from the schedule, as _chunk_proof's does
        # (the tree hasher's proof carries no block count).
        return proof_data.root_hash, RecursiveChunkProof(
            rec=rproof, chunk_idx=chunk_idx, n_blocks=sched.n_blocks,
            leaf_depth=sched.leaf_depth, total_depth=proof_data.total_depth)

    def verify_recursive(self, proof: RecursiveChunkProof,
                         expected_hash: Optional[bytes] = None) -> bytes:
        """Verify a recursive chunk proof (the two state hashes, the three
        instances, the statement); returns the proven root."""
        check_statement(self.modulus, proof.rec.z0, proof.rec.n_steps,
                        proof.chunk_idx, proof.n_blocks, proof.leaf_depth,
                        proof.total_depth)
        return _proof_root(self.recursive.verify(proof.rec), proof,
                           expected_hash)

    def export_vk(self, path: str) -> None:
        """Write the standalone verification key (nova/vk.py): anyone can
        then verify chunk proofs with verify_with_vk or `verify --vk`."""
        export_vk(self.ivc, path, statement="blake3-chunk",
                  io_arity=IO_ARITY)

    def verify(self, proof: ChunkProof,
               expected_hash: Optional[bytes] = None) -> bytes:
        """Verify the fold chain and statement; returns the proven root."""
        check_statement(self.modulus, proof.ivc_proof.z0,
                        proof.ivc_proof.num_steps, proof.chunk_idx,
                        proof.n_blocks, proof.leaf_depth, proof.total_depth)
        return _proof_root(self.ivc.verify(proof.ivc_proof,
                                           io_arity=IO_ARITY),
                           proof, expected_hash)

    def verify_compressed(self, proof: CompressedChunkProof,
                          expected_hash: Optional[bytes] = None) -> bytes:
        """Verify a compressed chunk proof (the instance folds, the Spartan
        argument, the statement); returns the proven root."""
        check_statement(self.modulus, proof.compressed.chain.z0,
                        proof.compressed.num_steps, proof.chunk_idx,
                        proof.n_blocks, proof.leaf_depth, proof.total_depth)
        return _proof_root(self.spartan.verify(proof.compressed,
                                               io_arity=IO_ARITY),
                           proof, expected_hash)

    def verify_segmented(self, proof: SegmentedChunkProof,
                         expected_hash: Optional[bytes] = None) -> bytes:
        """Verify every segment, their chaining and the statement."""
        check_statement(self.modulus, proof.segmented.z0,
                        proof.segmented.num_steps, proof.chunk_idx,
                        proof.n_blocks, proof.leaf_depth, proof.total_depth)
        return _proof_root(verify_segments(self.ivc, proof.segmented,
                                           io_arity=IO_ARITY),
                           proof, expected_hash)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    dev_help = "torch device (default: %(default)s)"
    p1 = sub.add_parser("prove")
    p1.add_argument("--file", required=True)
    p1.add_argument("--chunk", type=int, default=0)
    p1.add_argument("--out", default="proof.json")
    p1.add_argument("--compress", action="store_true",
                    help="write a succinct compressed proof (Spartan + IPA)")
    p1.add_argument("--device", default="cuda", help=dev_help)
    p2 = sub.add_parser("verify")
    p2.add_argument("--proof", required=True)
    p2.add_argument("--expect-hash", default=None)
    p2.add_argument("--vk", default=None,
                    help="verify from an exported vk.json alone (the "
                         "prover's circuit is never built)")
    p2.add_argument("--device", default="cuda", help=dev_help)
    p3 = sub.add_parser("export-vk")
    p3.add_argument("--out", default="vk.json")
    p3.add_argument("--device", default="cuda", help=dev_help)
    args = ap.parse_args(argv)

    if args.cmd == "verify":
        expect = bytes.fromhex(args.expect_hash) if args.expect_hash else None
        # With --vk the prover's circuit is never built.
        prover = None if args.vk else ChunkProver(device=args.device)
        t0 = time.time()
        try:
            proof = ChunkProof.load(args.proof)
        except ValueError:      # not a chunk proof: a compressed one?
            if prover is None:
                raise
            proof = CompressedChunkProof.load(args.proof)
        if isinstance(proof, CompressedChunkProof):
            root = prover.verify_compressed(proof, expect)
            n = proof.compressed.num_steps
        else:
            root = prover.verify(proof, expect) if prover else \
                verify_with_vk(args.vk, proof, expect, device=args.device)
            n = proof.ivc_proof.num_steps
        print(f"VERIFIED{' (vk-only)' if args.vk else ''} root hash: "
              f"{root.hex()}  ({time.time() - t0:.2f}s, {n} steps)")
        return

    prover = ChunkProver(device=args.device)
    if args.cmd == "export-vk":
        prover.export_vk(args.out)
        print(f"verification key written to {args.out}")
        return
    with open(args.file, "rb") as f:
        data = f.read()
    t0 = time.time()
    root, proof = prover.prove(data, args.chunk, progress=True)
    dt = time.time() - t0
    n = proof.ivc_proof.num_steps
    print(f"root hash: {root.hex()}")
    print(f"steps: {n}  time: {dt:.2f}s  folds/sec: {n / dt:.3f}")
    if args.compress:
        t0 = time.time()
        prover.compress(proof).save(args.out)
        print(f"compressed in {time.time() - t0:.2f}s")
    else:
        proof.save(args.out)
    print(f"proof written to {args.out}")


if __name__ == "__main__":
    main()
