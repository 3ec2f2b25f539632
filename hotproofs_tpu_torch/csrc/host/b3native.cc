// Native BLAKE3 tree hasher + Merkle-path extractor.
//
// The data-ingestion hot path of the proving stack: the reference repo gets
// this from the native `blake3` + `bao` crates (rust_fold/src/blake3_hash.rs)
// while round 1 of this stack used the pure-Python oracle
// (hotproofs_tpu/core/blake3_ref.py) — correct but ~3 orders of magnitude
// slower than native. This file implements the SAME hash-mode subset from
// the public BLAKE3 spec, bit-validated against the Python oracle in
// tests/test_native_hash.py; the Python oracle stays the ground truth.
//
// Scope mirrors blake3_ref.py exactly: hash mode only (no keyed/derive-key),
// chunk chaining, binary Merkle tree with largest-power-of-two-strictly-less
// left subtrees, root finalization, and the root-side-first sibling path the
// chunk prover consumes. Compiled on demand by core/native.py (g++ -O3).

#include <stdint.h>
#include <string.h>

namespace {

constexpr uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

constexpr int MSG_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13,
                              1, 11, 12, 5, 9, 14, 15, 8};

constexpr uint32_t CHUNK_START = 1u << 0;
constexpr uint32_t CHUNK_END = 1u << 1;
constexpr uint32_t PARENT = 1u << 2;
constexpr uint32_t ROOT = 1u << 3;

constexpr uint64_t BLOCK_LEN = 64;
constexpr uint64_t CHUNK_LEN = 1024;

static inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static inline void g(uint32_t* s, int a, int b, int c, int d, uint32_t mx,
                     uint32_t my) {
  s[a] = s[a] + s[b] + mx;
  s[d] = rotr32(s[d] ^ s[a], 16);
  s[c] = s[c] + s[d];
  s[b] = rotr32(s[b] ^ s[c], 12);
  s[a] = s[a] + s[b] + my;
  s[d] = rotr32(s[d] ^ s[a], 8);
  s[c] = s[c] + s[d];
  s[b] = rotr32(s[b] ^ s[c], 7);
}

// h[8] in, out_cv[8] = compressed chaining value. Only the CV half is
// needed internally (the full 16-word form exists for the circuits, which
// the Python side covers).
static void compress_cv(const uint32_t h[8], const uint32_t m_in[16],
                        uint64_t t, uint32_t b, uint32_t d,
                        uint32_t out_cv[8]) {
  uint32_t s[16] = {
      h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7],
      IV[0], IV[1], IV[2], IV[3],
      (uint32_t)t, (uint32_t)(t >> 32), b, d,
  };
  uint32_t m[16];
  memcpy(m, m_in, sizeof(m));
  for (int r = 0;; r++) {
    // Columns.
    g(s, 0, 4, 8, 12, m[0], m[1]);
    g(s, 1, 5, 9, 13, m[2], m[3]);
    g(s, 2, 6, 10, 14, m[4], m[5]);
    g(s, 3, 7, 11, 15, m[6], m[7]);
    // Diagonals.
    g(s, 0, 5, 10, 15, m[8], m[9]);
    g(s, 1, 6, 11, 12, m[10], m[11]);
    g(s, 2, 7, 8, 13, m[12], m[13]);
    g(s, 3, 4, 9, 14, m[14], m[15]);
    if (r == 6) break;
    uint32_t nm[16];
    for (int i = 0; i < 16; i++) nm[i] = m[MSG_PERM[i]];
    memcpy(m, nm, sizeof(m));
  }
  for (int i = 0; i < 8; i++) out_cv[i] = s[i] ^ s[i + 8];
}

static void load_block_words(const uint8_t* p, uint64_t len, uint32_t m[16]) {
  uint8_t buf[64];
  memset(buf, 0, sizeof(buf));
  memcpy(buf, p, (size_t)len);
  for (int i = 0; i < 16; i++) {
    m[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8) |
           ((uint32_t)buf[4 * i + 2] << 16) | ((uint32_t)buf[4 * i + 3] << 24);
  }
}

// CV of one chunk (<= 1024 bytes; len == 0 allowed for the empty input).
static void chunk_cv(const uint8_t* p, uint64_t len, uint64_t chunk_idx,
                     bool is_root, uint32_t out[8]) {
  uint64_t n_blocks = len ? (len + BLOCK_LEN - 1) / BLOCK_LEN : 1;
  uint32_t h[8];
  memcpy(h, IV, sizeof(h));
  for (uint64_t i = 0; i < n_blocks; i++) {
    uint64_t off = i * BLOCK_LEN;
    uint64_t blen = len - off < BLOCK_LEN ? len - off : BLOCK_LEN;
    uint32_t d = 0;
    if (i == 0) d |= CHUNK_START;
    if (i == n_blocks - 1) {
      d |= CHUNK_END;
      if (is_root) d |= ROOT;
    }
    uint32_t m[16];
    load_block_words(p + off, blen, m);
    compress_cv(h, m, chunk_idx, (uint32_t)blen, d, h);
  }
  memcpy(out, h, 8 * sizeof(uint32_t));
}

static void parent(const uint32_t left[8], const uint32_t right[8],
                   bool is_root, uint32_t out[8]) {
  uint32_t m[16];
  memcpy(m, left, 8 * sizeof(uint32_t));
  memcpy(m + 8, right, 8 * sizeof(uint32_t));
  compress_cv(IV, m, 0, (uint32_t)BLOCK_LEN, PARENT | (is_root ? ROOT : 0),
              out);
}

static uint64_t left_split(uint64_t n) {  // largest power of two < n
  uint64_t p = 1;
  while (p * 2 < n) p *= 2;
  return p;
}

struct Ctx {
  const uint8_t* data;
  uint64_t len;
  uint64_t n_chunks;
  // Path recording (leaf-side first during the walk; caller reverses).
  int64_t target;  // chunk_idx being proven, or -1
  uint8_t* sib_out;
  uint8_t* dir_out;
  int depth;
  int cap;
  bool overflow;
};

static void chunk_of(const Ctx& c, uint64_t idx, bool is_root,
                     uint32_t out[8]) {
  uint64_t off = idx * CHUNK_LEN;
  uint64_t clen = c.len - off < CHUNK_LEN ? c.len - off : CHUNK_LEN;
  chunk_cv(c.data + off, clen, idx, is_root, out);
}

// CV of chunks [lo, hi); records path nodes when target is inside.
static void walk(Ctx& c, uint64_t lo, uint64_t hi, bool is_root,
                 uint32_t out[8]) {
  if (hi - lo == 1) {
    chunk_of(c, lo, is_root, out);
    return;
  }
  uint64_t split = lo + left_split(hi - lo);
  uint32_t left[8], right[8];
  bool on_path = c.target >= 0 && (uint64_t)c.target >= lo &&
                 (uint64_t)c.target < hi;
  walk(c, lo, split, false, left);
  walk(c, split, hi, false, right);
  if (on_path) {
    if (c.depth >= c.cap) {
      c.overflow = true;
    } else {
      bool down_left = (uint64_t)c.target < split;
      const uint32_t* sib = down_left ? right : left;
      memcpy(c.sib_out + 32 * c.depth, sib, 32);
      c.dir_out[c.depth] = down_left ? 1 : 0;
      c.depth++;
    }
  }
  parent(left, right, is_root, out);
}

static int full_tree_depth(uint64_t n_chunks) {
  // Node-depth of the deepest leaf: ceil(log2(n)) + 1; 1 for a single chunk.
  int d = 1;
  uint64_t cap = 1;
  while (cap < n_chunks) {
    cap *= 2;
    d += 1;
  }
  return d;
}

}  // namespace

extern "C" {

// 32-byte BLAKE3 hash of data[0:len]. Returns 0.
int b3n_hash(const uint8_t* data, uint64_t len, uint8_t out[32]) {
  Ctx c{data, len, len ? (len + CHUNK_LEN - 1) / CHUNK_LEN : 1,
        -1, nullptr, nullptr, 0, 0, false};
  uint32_t cv[8];
  walk(c, 0, c.n_chunks, true, cv);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)cv[i];
    out[4 * i + 1] = (uint8_t)(cv[i] >> 8);
    out[4 * i + 2] = (uint8_t)(cv[i] >> 16);
    out[4 * i + 3] = (uint8_t)(cv[i] >> 24);
  }
  return 0;
}

// Hash + Merkle path for chunk_idx. sib_out: cap*32 bytes; dir_out: cap
// bytes — filled LEAF-side first (caller reverses to root-side first).
// Returns the path length (leaf_depth - 1), or -1 (bad chunk_idx) /
// -2 (cap too small). total_depth_out gets the full-tree depth.
int b3n_hash_with_path(const uint8_t* data, uint64_t len, uint64_t chunk_idx,
                       uint8_t root_out[32], uint8_t* sib_out,
                       uint8_t* dir_out, int cap, int32_t* total_depth_out) {
  uint64_t n_chunks = len ? (len + CHUNK_LEN - 1) / CHUNK_LEN : 1;
  if (chunk_idx >= n_chunks) return -1;
  Ctx c{data, len, n_chunks, (int64_t)chunk_idx,
        sib_out, dir_out, 0, cap, false};
  uint32_t cv[8];
  walk(c, 0, n_chunks, true, cv);
  if (c.overflow) return -2;
  for (int i = 0; i < 8; i++) {
    root_out[4 * i] = (uint8_t)cv[i];
    root_out[4 * i + 1] = (uint8_t)(cv[i] >> 8);
    root_out[4 * i + 2] = (uint8_t)(cv[i] >> 16);
    root_out[4 * i + 3] = (uint8_t)(cv[i] >> 24);
  }
  *total_depth_out = full_tree_depth(n_chunks);
  return c.depth;
}

}  // extern "C"
