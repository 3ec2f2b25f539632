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
//   One warp a row; its lanes converge on each add, so a row lasts as many
//   adds as its busiest lane has digits. The lanes are balanced over the
//   row's digit values: value v, with n_v digits in the row, takes a_v
//   lanes, a_v chosen on the host (ops/tables.py: lane_alloc) by giving
//   each of the 32 lanes in turn to the value of the most adds a lane, so
//   a lane walks about n_v / a_v digits (the row's digits of its value,
//   every a_v-th one; tables.cuh: table_lane). On the BLAKE3 primary's
//   tables that is 1,075,446 walk warp-steps where the half-warp map it
//   replaced (lane v of each half-warp the bucket of value v + 1 over
//   alternate nonzeros) took 1,507,169. Then the parts of a value are summed by a halving tree
//   over their lanes (up to log2 max a_v levels of shuffles and complete
//   adds), value v's sum is gathered to lane v - 1, and K3's lane schedule
//   (msm.cuh: wsum_lanes) sums v * B_v over the first 16 lanes, 8
//   dependent complete adds, identities skipped. Rows run longest walk
//   first (the wrapper's `order`). What bounds it: the adds' multiplies
//   (the carry and high-half forms issue about one a clock an SM), and
//   instruction fetch where its warps stand in different adds at once
//   (the walk's mixed add, the joins' complete adds), which the lean
//   backend's rolled CIOS round keeps small (field_lean.cuh); the gathered
//   bases are not (every column < 256 ran the same); the walk's digit scan
//   is a few integer operations a word of 8 digits.
#include <cuda_runtime.h>

#include "tables.cuh"

using namespace hp;

// r = lane src's point, across the whole warp.
__device__ __forceinline__ void shfl_proj(const Proj& a, int src, Proj& r) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    r.x[k] = __shfl_sync(0xffffffffu, a.x[k], src);
    r.y[k] = __shfl_sync(0xffffffffu, a.y[k], src);
    r.z[k] = __shfl_sync(0xffffffffu, a.z[k], src);
  }
}

// Warp w builds row order[w] (tables.cuh: table_lane is the per-lane order
// of adds). The host replay is hc_h_tables.
__global__ void __launch_bounds__(TABLE_THREADS)
    k_h_tables(LeanConsts c, const int* __restrict__ row_ptr,
               const int* __restrict__ order, const int* __restrict__ alloc,
               const int* __restrict__ cols, const u32* __restrict__ mag,
               const int* __restrict__ neg, const u32* __restrict__ bases_lm,
               u32* __restrict__ out, int R, int B, int lpw) {
  const long long warp =
      ((long long)blockIdx.x * TABLE_THREADS + threadIdx.x) >> 5;
  if (warp >= R) return;  // the whole warp: no row
  const int lane = threadIdx.x & 31;
  const int row = order[warp];
  const TableLane tl = table_lane_map(alloc + (size_t)row * 4, lane);
  Proj acc;
  pt_identity(c, acc);
  long long k = row_ptr[row];
  const long long k1 = row_ptr[row + 1];
  int w = 0, skip = tl.part;
#pragma unroll 1
  while (true) {
    const bool have = tl.v && next_match(mag, k, w, k1, tl.v, skip);
    if (!__any_sync(0xffffffffu, have)) break;
    if (have) {
      Aff q;
      table_base(c, bases_lm, B, lpw, cols[k], w, neg[k], q);
      pt_add_mixed(c, acc, q, acc);
      ++w;
      skip = tl.parts - 1;
    }
  }
#pragma unroll 1
  for (int off = 1; off < tl.amax; off <<= 1) {
    Proj o;
    shfl_down_proj(acc, off, o);
    if (table_seg_takes(tl, off)) acc_add(c, acc, o);
  }
  Proj g;
  shfl_proj(acc, tl.head < 0 ? 0 : tl.head, g);
  if (lane >= NBUCKET || tl.head < 0) pt_identity(c, g);
  wsum_lanes(c, g, lane & 15, 16);
  if (lane == 0) store_proj(out + (size_t)row * 3 * NW, 1, g);
}

extern "C" {

// lean_consts: the 34 words of load_lean_consts; bases_lm: the key's
// lane-major (n_lanes, B, 2, 8) bases, 16-byte aligned.
int hp_h_tables(const u32* lean_consts, const int* row_ptr, const int* order,
                const int* alloc, const int* cols, const u32* mag,
                const int* neg, const u32* bases_lm, u32* out, int R, int B,
                int lpw, void* stream) {
  k_h_tables<<<blocks_for((long long)R * 32, TABLE_THREADS), TABLE_THREADS,
               0, (cudaStream_t)stream>>>(load_lean_consts(lean_consts),
                                          row_ptr, order, alloc, cols, mag,
                                          neg, bases_lm, out, R, B, lpw);
  return (int)cudaGetLastError();
}

}  // extern "C"
