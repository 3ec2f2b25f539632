// Hopper kernel that builds Spartan's matrix tables (nova/spartan.py:
// preprocess_H): for every row x of A, B and C, H_M[x] = sum_y M[x, y] G_y
// over the key's generators. Built by nvcc for sm_90a into the same shared
// library as msm.cu (ops/cuda_lib.py), bound with ctypes; the launcher runs
// on the caller's stream, allocates nothing and returns cudaGetLastError().
//
// h_tables replaces the reference's host loop (hotproofs_tpu/nova/
//   spartan.py:427-493), one native fold_point a nonzero: a full scalar
//   multiplication and an inversion, about 250 us a nonzero on the host, 4
//   minutes for the 1,026,000 nonzeros of the recursive SNARK's BLAKE3
//   pair. Here the work is one 11-multiply mixed add per nonzero radix-16
//   digit over the key's prepared bases 16^w G (the MSM's own, read
//   lane-major), with each value v taken as min(v, p - v) and the point
//   negated where p - v is shorter: 70-80 % of the augmented circuits' A
//   and B values are full-width constants, which this halves at most.
//   One warp a row. Lane v of each half-warp is the bucket of digit value
//   v + 1 (lane 15 idles) and walks its half of the row's nonzeros
//   (alternate ones) for the digits equal to its value (tables.cuh:
//   table_lane); the lanes of a warp converge on each add, so a warp runs
//   as many adds as its busiest lane has digits, about a fifteenth of the
//   row's. Then K3's lane schedule (msm.cuh: wsum_lanes) sums v * B_v in
//   each half, 8 dependent complete adds, and lane 0 adds the two halves.
//   Rows run longest first (the wrapper's `order`): the longest rows (259
//   nonzeros beside a p99 of about 60) start in the first wave instead of
//   trailing the last. What bounds it: the products of the adds, and on a
//   short row the latency of its 9 dependent complete adds; the walk's
//   digit scan is a few integer operations a word of 8 digits.
#include <cuda_runtime.h>

#include "tables.cuh"

using namespace hp;

// Warp w builds row order[w] (tables.cuh: table_lane is the per-lane order
// of adds). The host replay is hc_h_tables.
__global__ void __launch_bounds__(TABLE_THREADS)
    k_h_tables(Consts c, const int* __restrict__ row_ptr,
               const int* __restrict__ order, const int* __restrict__ cols,
               const u32* __restrict__ mag, const int* __restrict__ neg,
               const u32* __restrict__ bases_lm, u32* __restrict__ out, int R,
               int B, int lpw) {
  const long long warp =
      ((long long)blockIdx.x * TABLE_THREADS + threadIdx.x) >> 5;
  if (warp >= R) return;  // the whole warp: no row
  const int lane = threadIdx.x & 31, v = lane & 15;
  const int row = order[warp];
  Proj acc;
  pt_identity(c, acc);
  long long k = row_ptr[row] + (lane >> 4);
  const long long k1 = row_ptr[row + 1];
  int w = 0;
#pragma unroll 1
  while (true) {
    const bool have = v < NBUCKET && next_digit(mag, k, w, k1, v + 1);
    if (!__any_sync(0xffffffffu, have)) break;
    if (have) {
      Aff q;
      table_base(c, bases_lm, B, lpw, cols[k], w, neg[k], q);
      pt_add_mixed(c, acc, q, acc);
      ++w;
    }
  }
  wsum_lanes(c, acc, v, 16);
  Proj o;
  shfl_down_proj(acc, 16, o);
  if (lane == 0) {
    acc_add(c, acc, o);
    store_proj(out + (size_t)row * 3 * NW, 1, acc);
  }
}

extern "C" {

// bases_lm: the key's lane-major (n_lanes, B, 2, 8) bases, 16-byte aligned.
int hp_h_tables(const u32* consts, const int* row_ptr, const int* order,
                const int* cols, const u32* mag, const int* neg,
                const u32* bases_lm, u32* out, int R, int B, int lpw,
                void* stream) {
  k_h_tables<<<blocks_for((long long)R * 32, TABLE_THREADS), TABLE_THREADS,
               0, (cudaStream_t)stream>>>(load_consts(consts), row_ptr, order,
                                          cols, mag, neg, bases_lm, out, R, B,
                                          lpw);
  return (int)cudaGetLastError();
}

}  // extern "C"
