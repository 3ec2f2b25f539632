// Per-lane body of the matrix-table kernel (tables.cu): Spartan's tables
// H_M[x] = sum_k v_k G_{c_k} over the nonzeros of row x. It is
// __host__ __device__ so the CPU tests run the exact per-lane code
// (csrc/host_check.cc, tests/test_torch_cuda_host.py).
//
// Layouts (u32 words unless stated):
//   row_ptr (R + 1,) int32   row r's nonzeros are [row_ptr[r], row_ptr[r+1])
//   order   (R,) int32       the rows, longest walk first (warp w takes
//                            order[w])
//   alloc   (R, 4) int32     byte v - 1 of a row's 16 bytes (little-endian
//                            words): a_v, the lanes of its warp that digit
//                            value v = 1..15 takes (sum <= 32; 0 where the
//                            row has no digit v, else 1 <= a_v <= n_v, its
//                            digits of value v)
//   cols    (nnz,) int32     the generator index of each nonzero
//   mag     (nnz, 8)         min(v, p - v), canonical, of each value v
//   neg     (nnz,) int32     1 where mag = p - v (the point is negated)
//   bases_lm (n_lanes, B, 2, 8)  the key's prepared bases (msm.cuh), the
//                            affine 16^w G_c at lane w * lpw + c / B, step
//                            c % B
//   out     (R, 3, 8)        projective H per row, the identity if empty
#pragma once

#include "field_lean.cuh"
#include "msm.cuh"

namespace hp {

constexpr int TABLE_THREADS = 128;  // 4 warps, 4 rows a block
constexpr int TABLE_WINDOWS = 64;   // radix-16 windows of a 256-bit value
constexpr int TABLE_LANES = 32;     // one warp a row

HP_HD int ctz32(u32 x) {
#ifdef __CUDA_ARCH__
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// Advance (k, w) to the next nonzero digit equal to d, from (k, w) itself,
// over the nonzeros k < k1 of a row and windows w < 64 of each. False
// when the row holds no more. A word holds 8 digits; z marks bit 3 of
// each digit of y that is zero, so one test a word finds the matches.
HP_HD bool next_digit(const u32* mag, long long& k, int& w, long long k1,
                      int d) {
  const u32 pat = 0x11111111u * (u32)d;
  while (k < k1) {
    while (w < TABLE_WINDOWS) {
      const u32 y = mag[(size_t)k * NW + (w >> 3)] ^ pat;
      const u32 z = ~(((y & 0x77777777u) + 0x77777777u) | y | 0x77777777u);
      const u32 hit = z & (0xFFFFFFFFu << ((w & 7) * 4));
      if (hit) {
        w = (w & ~7) + (ctz32(hit) >> 2);
        return true;
      }
      w = (w & ~7) + 8;
    }
    ++k;
    w = 0;
  }
  return false;
}

// next_digit after passing `skip` matches (skip is left at 0).
HP_HD bool next_match(const u32* mag, long long& k, int& w, long long k1,
                      int d, int& skip) {
  while (next_digit(mag, k, w, k1, d)) {
    if (!skip) return true;
    --skip;
    ++w;
  }
  return false;
}

// q = +-16^w G_col from the key's lane-major bases; y negated if neg.
HP_HD void table_base(const LeanConsts& c, const u32* bases_lm, int B,
                      int lpw, int col, int w, int neg, Aff& q) {
  load_base_lm(bases_lm, B, col % B, w * lpw + col / B, q);
  if (neg) {
    u32 zero[NW];
    fe_zero(zero);
    fe_sub(c, zero, q.y, q.y);
  }
}

// What lane `lane` of a row's warp does, from the row's alloc: the lanes
// take the values in order, value v on lanes [s_v, s_v + a_v), s_v = a_1
// + ... + a_{v-1}; lanes past the last value are idle (v = 0).
struct TableLane {
  int v;      // its digit value, 0 if idle
  int part;   // lane - s_v: it takes the matches i of v with i % a_v = part
  int parts;  // a_v
  int head;   // s_{lane+1}, the first lane of value lane + 1; -1 if none
  int amax;   // max_v a_v (the same for the whole warp)
};

HP_HD TableLane table_lane_map(const int* alloc_row, int lane) {
  TableLane t = {0, 0, 0, -1, 0};
  int s = 0;
  for (int v = 1; v <= NBUCKET; ++v) {
    const int a = ((u32)alloc_row[(v - 1) >> 2] >> (8 * ((v - 1) & 3))) &
                  0xFF;
    if (lane >= s && lane < s + a) {
      t.v = v;
      t.part = lane - s;
      t.parts = a;
    }
    if (v == lane + 1 && a) t.head = s;
    if (a > t.amax) t.amax = a;
    s += a;
  }
  return t;
}

// Lane `lane` of row `row`'s warp: mixed-adds, from the identity, every
// +-16^w G_c whose digit w of mag is its value v and which is match i of
// that value in the row (in the order of k, then w) with i % a_v = part,
// in that order: lane (v, part) holds part `part` of bucket v. The kernel
// runs the same adds in the same order, with the lanes of a warp
// converging on each add (k_h_tables).
HP_HD void table_lane(const LeanConsts& c, const int* row_ptr,
                      const int* alloc, const int* cols, const u32* mag,
                      const int* neg, const u32* bases_lm, int B, int lpw,
                      int row, int lane, Proj& acc) {
  pt_identity(c, acc);
  const TableLane tl = table_lane_map(alloc + (size_t)row * 4, lane);
  if (!tl.v) return;
  long long k = row_ptr[row];
  const long long k1 = row_ptr[row + 1];
  int w = 0, skip = tl.part;
  while (next_match(mag, k, w, k1, tl.v, skip)) {
    Aff q;
    table_base(c, bases_lm, B, lpw, cols[k], w, neg[k], q);
    pt_add_mixed(c, acc, q, acc);
    ++w;
    skip = tl.parts - 1;
  }
}

// The join's first part: the parts of each value are summed by a halving
// tree over their lanes, at levels off = 1, 2, ... below amax; true where
// lane t takes the lane off above it (part p of a multiple of 2 off, part
// p + off present; acc_add). Part 0 of value v ends holding B_v. Every
// lane reads the level's inputs (the kernel's shuffles).
HP_HD bool table_seg_takes(const TableLane& t, int off) {
  return t.v && t.part % (2 * off) == 0 && t.part + off < t.parts;
}

}  // namespace hp
