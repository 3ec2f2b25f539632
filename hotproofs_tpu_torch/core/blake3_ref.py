"""Pure-Python BLAKE3 reference implementation (host-side oracle).

This is the ground-truth oracle for the TPU proving stack, playing the role the
vendored JS implementation (`test/blake3_utils/compressions.js`) and the native
`blake3` crate (`rust_fold/src/blake3_hash.rs:32`) play in the reference repo.
It implements the hash-mode subset the proving system needs: chunk chaining,
the binary Merkle tree over chunk chaining values, and root finalization.

Capability parity targets (reference file:line):
  - compression function: circuits/blake3_compression.circom:171-228
  - chunk/tree semantics: rust_fold/src/blake3_hash.rs:17-93 (via the bao crate)

Only hash mode (no keyed hash / derive-key) is implemented, matching the
reference's scope.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

MASK32 = 0xFFFFFFFF

IV = (
    0x6A09E667,
    0xBB67AE85,
    0x3C6EF372,
    0xA54FF53A,
    0x510E527F,
    0x9B05688C,
    0x1F83D9AB,
    0x5BE0CD19,
)

# Official BLAKE3 message permutation. (The comment in
# circuits/blake3_common.circom:13-14 claims this is "the wrong permutation";
# it is in fact the official one — see SURVEY.md §5 note 2.)
MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

# Domain flags (circuits/blake3_nova.circom:123-126).
CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024
MAX_BLOCKS_PER_CHUNK = CHUNK_LEN // BLOCK_LEN  # 16


def _rotr32(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _g(state: List[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & MASK32
    state[d] = _rotr32(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr32(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & MASK32
    state[d] = _rotr32(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr32(state[b] ^ state[c], 7)


def _round(state: List[int], m: Sequence[int]) -> None:
    # Columns.
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    # Diagonals.
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def compress(
    h: Sequence[int],
    m: Sequence[int],
    t: int,
    b: int,
    d: int,
) -> List[int]:
    """Full 16-word-output compression.

    Mirrors the full-output mode of the circom circuit: out[0:8] is the new
    chaining value, out[8:16] is the upper state XOR'd with the input h
    (circuits/blake3_compression.circom:213-227).
    """
    assert len(h) == 8 and len(m) == 16
    state = [
        h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7],
        IV[0], IV[1], IV[2], IV[3],
        t & MASK32, (t >> 32) & MASK32, b & MASK32, d & MASK32,
    ]
    block = list(m)
    for r in range(7):
        _round(state, block)
        if r < 6:
            block = [block[p] for p in MSG_PERMUTATION]
    out = [0] * 16
    for i in range(8):
        out[i] = state[i] ^ state[i + 8]
        out[i + 8] = state[i + 8] ^ h[i]
    return out


def words_from_block_bytes(block: bytes) -> List[int]:
    """Little-endian u32 words of a <=64-byte block, zero padded to 16 words.

    Mirrors rust_fold/src/utils.rs:90-98 (bytes_to_u32_le) plus the zero
    padding in blake3_circuit.rs:206-215.
    """
    assert len(block) <= BLOCK_LEN
    padded = block + b"\x00" * (BLOCK_LEN - len(block))
    return [int.from_bytes(padded[4 * i: 4 * i + 4], "little") for i in range(16)]


def chunk_chaining_value(chunk: bytes, chunk_idx: int, is_root: bool) -> List[int]:
    """Chaining value (8 words) of one chunk (<=1024 bytes)."""
    assert len(chunk) <= CHUNK_LEN
    blocks = [chunk[i: i + BLOCK_LEN] for i in range(0, len(chunk), BLOCK_LEN)] or [b""]
    h = list(IV)
    n = len(blocks)
    for i, blk in enumerate(blocks):
        d = 0
        if i == 0:
            d |= CHUNK_START
        if i == n - 1:
            d |= CHUNK_END
            if is_root:
                d |= ROOT
        out = compress(h, words_from_block_bytes(blk), chunk_idx, len(blk), d)
        h = out[:8]
    return h


def parent_cv(left: Sequence[int], right: Sequence[int], is_root: bool) -> List[int]:
    """Chaining value of a parent node over two child CVs."""
    d = PARENT | (ROOT if is_root else 0)
    m = list(left) + list(right)
    return compress(list(IV), m, 0, BLOCK_LEN, d)[:8]


def left_subtree_chunks(n_chunks: int) -> int:
    """Number of chunks in the left subtree: largest power of two < n_chunks."""
    assert n_chunks > 1
    p = 1
    while p * 2 < n_chunks:
        p *= 2
    return p


def _tree_cv(chunks: List[bytes], base_idx: int, is_root: bool) -> List[int]:
    if len(chunks) == 1:
        return chunk_chaining_value(chunks[0], base_idx, is_root)
    split = left_subtree_chunks(len(chunks))
    left = _tree_cv(chunks[:split], base_idx, False)
    right = _tree_cv(chunks[split:], base_idx + split, False)
    return parent_cv(left, right, is_root)


def split_chunks(data: bytes) -> List[bytes]:
    if len(data) == 0:
        return [b""]
    return [data[i: i + CHUNK_LEN] for i in range(0, len(data), CHUNK_LEN)]


def hash_words(data: bytes) -> List[int]:
    """Root chaining value (8 little-endian u32 words) of arbitrary input."""
    chunks = split_chunks(data)
    return _tree_cv(chunks, 0, True)


def hash_bytes(data: bytes) -> bytes:
    """32-byte BLAKE3 hash (default output length)."""
    return b"".join(w.to_bytes(4, "little") for w in hash_words(data))


def hash_hex(data: bytes) -> str:
    return hash_bytes(data).hex()


@dataclass
class PathNode:
    """One parent level on the root->leaf path.

    `down_left` is True when the path descends to the LEFT child at this node
    (the reference encodes the same thing as PathDirection::Left,
    rust_fold/src/blake3_circuit.rs:36-53). `sibling_cv` is the chaining value
    (8 LE words) of the child NOT on the path.
    """

    down_left: bool
    sibling_cv: List[int]


@dataclass
class HashProof:
    """Everything the prover needs for one chunk: reference Blake3HashProof
    (rust_fold/src/blake3_hash.rs:11-15), plus the full-tree depth.

    total_depth is the node-depth of the DEEPEST leaf of the tree
    (= ceil(log2(n_chunks)) + 1); leaf_depth is the node-depth of this chunk's
    leaf (= len(parent_path) + 1). The reference driver conflates the two
    (rust_fold/src/main.rs:73 passes leaf path depth as total_depth), which
    makes its chunk_idx-bit path-direction rule wrong for trees whose leaf
    sits above the deepest level (non-power-of-two chunk counts). We keep the
    circuit-source semantics (circuits/blake3_nova.circom:62-72), which are
    correct exactly when total_depth is the full-tree depth.
    """

    chunk_idx: int
    parent_path: List[PathNode]  # root-side first, leaf's parent last
    chunk_bytes: bytes
    total_depth: int
    leaf_depth: int
    root_hash: bytes


def full_tree_depth(n_chunks: int) -> int:
    d = 1
    p = 1
    while p < n_chunks:
        p *= 2
        d += 1
    return d


def hash_with_path(data: bytes, chunk_idx: int) -> HashProof:
    """Hash `data` and extract the Merkle path for chunk `chunk_idx`.

    TPU-native equivalent of rust_fold/src/blake3_hash.rs:17-93 — but computed
    directly from the CV tree instead of re-parsing a bao-encoded byte stream.
    Returns sibling CVs ordered root-side first, like the reference's
    SliceExtractor output.
    """
    chunks = split_chunks(data)
    n_chunks = len(chunks)
    assert 0 <= chunk_idx < n_chunks, "chunk_idx out of range"

    path: List[PathNode] = []

    def walk(lo: int, hi: int, is_root: bool) -> List[int]:
        """Returns CV of chunks[lo:hi]; records path nodes along the way."""
        if hi - lo == 1:
            return chunk_chaining_value(chunks[lo], lo, is_root)
        split = lo + left_subtree_chunks(hi - lo)
        on_path = lo <= chunk_idx < hi
        if on_path:
            if chunk_idx < split:
                # Descend left; need right sibling CV (computed without path).
                left = walk(lo, split, False)
                right = _tree_cv(chunks[split:hi], split, False)
                path.append(PathNode(down_left=True, sibling_cv=right))
                # note: appended AFTER recursion => leaf-side first; fixed below
            else:
                left = _tree_cv(chunks[lo:split], lo, False)
                right = walk(split, hi, False)
                path.append(PathNode(down_left=False, sibling_cv=left))
            return parent_cv(left, right, is_root)
        left = _tree_cv(chunks[lo:split], lo, False)
        right = _tree_cv(chunks[split:hi], split, False)
        return parent_cv(left, right, is_root)

    root_cv = walk(0, n_chunks, True)
    path.reverse()  # root-side first
    root = b"".join(w.to_bytes(4, "little") for w in root_cv)
    return HashProof(
        chunk_idx=chunk_idx,
        parent_path=path,
        chunk_bytes=chunks[chunk_idx],
        total_depth=full_tree_depth(n_chunks),
        leaf_depth=len(path) + 1,
        root_hash=root,
    )


def synthetic_deep_path_proof(chunk_bytes: bytes, n_parents: int,
                              seed: int = 0) -> HashProof:
    """A valid HashProof whose leaf sits `n_parents` levels below the root
    of a SYNTHETIC tree: sibling CVs are random, the path hashes up exactly
    as BLAKE3 parents do, and the resulting statement ("this chunk's CV is
    a depth-n_parents descendant of root R") is fully verified by the step
    circuit — only the tree AROUND the path is made up.

    Purpose: long-single-chain runs (BASELINE config 5's 2^16-step chain,
    tools/longchain_deep.py). A real file's path depth grows with
    log2(size), so a 4096-step chain would need a 2^4080-chunk file; the
    fold/verify work per step is identical either way, and every
    compression in the chain is real."""
    import numpy as _np

    assert 1 <= len(chunk_bytes) <= 1024
    rng = _np.random.RandomState(seed)
    cv = chunk_chaining_value(chunk_bytes, 0, is_root=(n_parents == 0))
    path: List[PathNode] = []
    for i in range(n_parents):
        sibling = [int(v) for v in rng.randint(0, 1 << 32, size=8,
                                               dtype=_np.uint64)]
        down_left = bool(rng.randint(0, 2))
        is_root = i == n_parents - 1
        if down_left:
            cv = parent_cv(cv, sibling, is_root)
        else:
            cv = parent_cv(sibling, cv, is_root)
        path.append(PathNode(down_left=down_left, sibling_cv=sibling))
    path.reverse()  # root-side first, like hash_with_path
    root = b"".join(w.to_bytes(4, "little") for w in cv)
    return HashProof(
        chunk_idx=0,
        parent_path=path,
        chunk_bytes=bytes(chunk_bytes),
        total_depth=n_parents + 1,
        leaf_depth=n_parents + 1,
        root_hash=root,
    )
