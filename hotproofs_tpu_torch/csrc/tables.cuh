// Per-lane body of the matrix-table kernel (tables.cu): Spartan's tables
// H_M[x] = sum_k v_k G_{c_k} over the nonzeros of row x. It is
// __host__ __device__ so the CPU tests run the exact per-lane code
// (csrc/host_check.cc, tests/test_torch_cuda_host.py).
//
// Layouts (u32 words unless stated):
//   row_ptr (R + 1,) int32   row r's nonzeros are [row_ptr[r], row_ptr[r+1])
//   order   (R,) int32       the rows, longest first (warp w takes order[w])
//   cols    (nnz,) int32     the generator index of each nonzero
//   mag     (nnz, 8)         min(v, p - v), canonical, of each value v
//   neg     (nnz,) int32     1 where mag = p - v (the point is negated)
//   bases_lm (n_lanes, B, 2, 8)  the key's prepared bases (msm.cuh), the
//                            affine 16^w G_c at lane w * lpw + c / B, step
//                            c % B
//   out     (R, 3, 8)        projective H per row, the identity if empty
#pragma once

#include "msm.cuh"

namespace hp {

constexpr int TABLE_THREADS = 128;  // 4 warps, 4 rows a block
constexpr int TABLE_WINDOWS = 64;   // radix-16 windows of a 256-bit value

HP_HD int ctz32(u32 x) {
#ifdef __CUDA_ARCH__
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// Advance (k, w) to the next nonzero digit equal to d, from (k, w) itself,
// over the nonzeros k, k + 2, ... < k1 (a lane's half of its row) and
// windows w < 64 of each. False when the half holds no more. A word holds
// 8 digits; z marks bit 3 of each digit of y that is zero, so one test a
// word finds the matches.
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
    k += 2;
    w = 0;
  }
  return false;
}

// q = +-16^w G_col from the key's lane-major bases; y negated if neg.
HP_HD void table_base(const Consts& c, const u32* bases_lm, int B, int lpw,
                      int col, int w, int neg, Aff& q) {
  load_base_lm(bases_lm, B, col % B, w * lpw + col / B, q);
  if (neg) {
    u32 zero[NW];
    fe_zero(zero);
    fe_sub(c, zero, q.y, q.y);
  }
}

// Lane `lane` of row `row`'s warp: half h = lane / 16 takes the row's
// nonzeros k0 + h, k0 + h + 2, ...; lane v = lane % 16 < 15 is the bucket
// of digit value v + 1 and mixed-adds, from the identity, every +-16^w G_c
// whose digit w of mag is v + 1, in the order of k, then w. Lane 15 keeps
// the identity. The kernel runs the same adds in the same order, with the
// lanes of a warp converging on each add (k_h_tables).
HP_HD void table_lane(const Consts& c, const int* row_ptr, const int* cols,
                      const u32* mag, const int* neg, const u32* bases_lm,
                      int B, int lpw, int row, int lane, Proj& acc) {
  pt_identity(c, acc);
  const int v = lane & 15;
  if (v >= NBUCKET) return;
  long long k = row_ptr[row] + (lane >> 4);
  const long long k1 = row_ptr[row + 1];
  int w = 0;
  while (next_digit(mag, k, w, k1, v + 1)) {
    Aff q;
    table_base(c, bases_lm, B, lpw, cols[k], w, neg[k], q);
    pt_add_mixed(c, acc, q, acc);
    ++w;
  }
}

}  // namespace hp
