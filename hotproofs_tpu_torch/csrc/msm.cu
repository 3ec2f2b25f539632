// Hopper kernels of the commitment path: the MSM chain bucket -> merge ->
// wsum, and the key preparation to_affine. Built by nvcc for sm_90a into a
// shared library with a plain C interface (ops/cuda_lib.py), bound with
// ctypes. Each launcher runs on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// K1 msm_bucket replaces _bucket_kernel (hotproofs_tpu/ops/msm_pallas.py:210).
//   One thread per (job, lane), BUCKET_LANES lanes of one job per block.
//   Work: one 11-multiply RCB15 mixed add per nonzero digit. What bounds
//   it is latency, not the multiplier: at comm_T (16k lanes, about one
//   warp per scheduler) each lane's ~60 dependent adds run at the latency
//   of their multiply chains, and at the W shapes (5 % of the digits
//   nonzero, up to 53 in one lane) a warp takes as long as its busiest
//   lane. A thread that keeps 15 buckets indexed by the digit (bucket_range,
//   the t-split's body) holds them in local memory (255 registers and a
//   2 KB stack, two blocks per SM), and its warp runs an add at every step
//   where any lane has a nonzero digit. Here instead a counting sort in
//   shared memory lists each lane's nonzero steps grouped by digit, and
//   one loop walks that list with one accumulator in registers (msm.cuh:
//   bucket_walk): a warp runs as many adds as its busiest lane has nonzero
//   digits. Two costs come with the walk, since the lanes of a warp stand
//   at different steps: a time-major base row per word (a sector a word
//   across a warp), answered by a lane-major copy of the bases read as
//   four 16-byte vectors, and bucket stores at different times, answered
//   by keeping finished buckets in local memory and storing all 15 in one
//   coalesced pass at the end.
// K2 msm_merge replaces _merge_kernel (msm_pallas.py:288).
//   P blocks of MERGE_THREADS threads per (job, slot), P = merge_parts(J,
//   S, n_lanes) so that the grid holds about 4 blocks per SM (P = 36 at
//   comm_T, where one block per (job, slot) filled 15 of 132 SMs; P = 1 at
//   W J=256). Work: one 12-multiply complete add per nonempty bucket and
//   per node of the trees; at the W shapes 99 % of the buckets are empty.
//   A thread sums its strided lanes, loading X and Y only where Z is not 0;
//   then 5 warp-shuffle levels and 3 over the warps replace an 8-level
//   shared-memory tree, and every add with the identity on one side is
//   skipped, so a warp of empty buckets runs no add at all. Each block
//   stores its partial; the one that draws the last ticket of an atomic
//   counter (zeroed by the wrapper) sums the P partials by the same tree
//   in index order, so the result does not depend on which block ends
//   last. Bound by the latency of the dependent adds along the tree.
// K3 msm_wsum replaces _wsum_kernel (msm_pallas.py:358).
//   sum_{v=1..S} v * B_v per job. Work: 2S complete adds, nothing for the
//   card; what bounds it is the latency of the adds that depend on each
//   other (about 29 us each on an H100 with one warp a scheduler). The
//   reference's running suffix sum, run by one thread a job, chains all
//   2S = 30 of them. Here a job's slots sit on G = wsum_group(S) lanes of a
//   warp (G = 16 and 2 jobs a warp at S = 15): lane v holds B_{v+1}, an
//   inclusive suffix scan over log2 G shuffle levels gives T_v = sum_{u>=v}
//   B_u, and a halving tree over log2 G more sums the T_v, which is
//   sum_v v * B_v. The critical path is 2 log2 G dependent adds (8 at
//   S = 15, 6 at S = 8). Every add with the identity on one side is
//   skipped (the lanes v >= S, empty slots).
// K4 to_affine replaces _inv_kernel / batch_inv_mont_lm (msm_pallas.py:66,
//   88) and _mont_mul_kernel / mont_mul_lm (pallas_field.py:267, 296) as
//   scaled_affine_device composes them (msm_pallas.py:156-170). The TPU
//   design raises every point's Z to p - 2 (a Fermat inversion, ~333
//   products a point): on the TPU that was one-time key preparation at
//   128 lanes a step; on this card it leaves the kernel bound by multiply
//   throughput at some 67 times the products it needs. So it was not
//   carried over. Here Montgomery's batch trick inverts a block's 4,096
//   points with one Fermat chain: each thread forms the running products
//   of its 16 points' Z (phase 1, written into x as scratch: no other
//   buffer), the block combines the 256 thread products by a prefix and a
//   suffix product scan in shared memory (8 levels), thread 0 inverts the
//   block's product (fe_inv, a sliding-window chain of 289 products), and
//   each thread walks its points back (phase 3): 5 products a point in
//   all. What bounds it is then the latency of that one Fermat chain, run
//   by every block at once (253 blocks at 1,034,368 points, all resident
//   at two an SM). A Z of 0 counts as 1 and gives (0, 0), as the
//   reference's is_zero does. One launch, one count.
#include <cuda_runtime.h>

#include "msm.cuh"

using namespace hp;

__global__ void __launch_bounds__(BUCKET_LANES)
    k_msm_bucket(Consts c, const int* __restrict__ digits,
                 const u32* __restrict__ bases_lm, u32* __restrict__ buckets,
                 int B, int n_lanes) {
  __shared__ unsigned char dig[BUCKET_MAX_STEPS * BUCKET_LANES];
  __shared__ unsigned char list[BUCKET_MAX_STEPS * BUCKET_LANES];
  __shared__ unsigned char cnt[(NBUCKET + 1) * BUCKET_LANES];
  const int t = threadIdx.x;
  const int l = blockIdx.x * BUCKET_LANES + t;
  if (l >= n_lanes) return;
  bucket_walk(c, digits, bases_lm, buckets, B, n_lanes, blockIdx.y, l,
              dig + t, list + t, cnt + t, BUCKET_LANES);
}

// Sums within groups of a merge block's threads: 5 shuffle levels in each
// warp (lane i < off takes lane i + off), then the same over the warp sums
// of each group of nw warps (nw = 1, 2 or MERGE_WARPS) in warp 0's first
// MERGE_WARPS lanes. Lane i of warp 0 with i % nw == 0 ends with the sum
// of group i / nw. The host replay is hc_msm_merge.
__device__ __noinline__ void group_sum(const Consts& c, Proj& acc, Proj* sh, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int off = 16; off > 0; off >>= 1) {
    Proj o;
    shfl_down_proj(acc, off, o);
    if (lane < off) acc_add(c, acc, o);
  }
  if (lane == 0) sh[warp] = acc;
  __syncthreads();
  if (warp != 0) return;
  if (lane < MERGE_WARPS)
    acc = sh[lane];
  else
    pt_identity(c, acc);
#pragma unroll 1
  for (int off = nw / 2; off > 0; off >>= 1) {
    Proj o;
    shfl_down_proj(acc, off, o);
    if (lane < MERGE_WARPS && lane % nw < off) acc_add(c, acc, o);
  }
}

// Thread gid = blockIdx.x * MERGE_THREADS + threadIdx.x is thread gid % G
// of slot gid / G (slot = job * S + s). With G <= MERGE_THREADS a block
// sums MERGE_THREADS / G slots whole; above it, P = G / MERGE_THREADS
// blocks each store a partial, and the last to draw a ticket sums them.
__global__ void __launch_bounds__(MERGE_THREADS, 4)
    k_msm_merge(Consts c, const u32* __restrict__ buckets,
                u32* __restrict__ reduced, u32* partials, int* tickets,
                int J, int S, int n_lanes, int G) {
  __shared__ Proj sh[MERGE_WARPS];
  __shared__ int last;
  const long long gid = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
  const int js = (int)(gid / G);
  Proj acc;
  if (js < J * S)
    merge_thread(c, buckets, S, n_lanes, js / S, js % S, (int)(gid % G), G,
                 acc);
  else
    pt_identity(c, acc);
  if (G <= MERGE_THREADS) {
    const int nw = G / 32;
    group_sum(c, acc, sh, nw);
    const int i = threadIdx.x;
    const long long out = ((long long)blockIdx.x * MERGE_THREADS + i * 32) / G;
    if (i < MERGE_WARPS && i % nw == 0 && out < (long long)J * S)
      store_proj(reduced + (size_t)out * 3 * NW, 1, acc);
    return;
  }
  group_sum(c, acc, sh, MERGE_WARPS);
  const int P = G / MERGE_THREADS, p = blockIdx.x % P;
  // Publish the partial, then draw a ticket: the block that draws P - 1
  // is the last of its slot and finishes it.
  if (threadIdx.x == 0) {
    store_proj(partials + ((size_t)js * P + p) * 3 * NW, 1, acc);
    __threadfence();
    last = atomicAdd(&tickets[js], 1) == P - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if ((int)threadIdx.x < P) {
    const u32* src = partials + ((size_t)js * P + threadIdx.x) * 3 * NW;
    for (int k = 0; k < NW; ++k) {  // L2 reads: other SMs wrote them
      acc.x[k] = __ldcg(src + k);
      acc.y[k] = __ldcg(src + NW + k);
      acc.z[k] = __ldcg(src + 2 * NW + k);
    }
  } else {
    pt_identity(c, acc);
  }
  group_sum(c, acc, sh, MERGE_WARPS);
  if (threadIdx.x == 0) store_proj(reduced + (size_t)js * 3 * NW, 1, acc);
}

// Thread gid is lane v = gid % G of job gid / G (G divides 32, so a warp
// holds 32 / G whole jobs). The host replay is hc_msm_wsum.
__global__ void __launch_bounds__(WSUM_THREADS)
    k_msm_wsum(Consts c, const u32* __restrict__ reduced,
               u32* __restrict__ out, int S, int J, int G) {
  const long long gid = (long long)blockIdx.x * WSUM_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if ((gid - lane) / G >= J) return;  // the whole warp: no job
  const long long j = gid / G;
  const int v = (int)(gid % G);
  Proj acc;
  wsum_lane(c, reduced, S, J, j, v, acc);
  wsum_lanes(c, acc, v, G);
  if (v == 0 && j < J) store_proj(out + (size_t)j * 3 * NW, 1, acc);
}

// Block b holds points [b AFFINE_BLOCK, (b + 1) AFFINE_BLOCK) (msm.cuh:
// affine_prefix). The host replay is hc_to_affine.
__global__ void __launch_bounds__(AFFINE_THREADS, 2)
    k_to_affine(Consts c, const u32* __restrict__ X,
                const u32* __restrict__ Y, const u32* __restrict__ Z, u32* x,
                u32* __restrict__ y, long long n) {
  __shared__ u32 pre[AFFINE_THREADS * NW], suf[AFFINE_THREADS * NW];
  __shared__ u32 inv[NW];
  const int t = threadIdx.x;
  const long long b = blockIdx.x;
  u32 q[NW];
  affine_prefix(c, Z, x, n, b, t, q);
  fe_copy(pre + t * NW, q);
  fe_copy(suf + t * NW, q);
  __syncthreads();
#pragma unroll 1
  for (int off = 1; off < AFFINE_THREADS; off <<= 1) {
    u32 p[NW], s[NW];
    const bool lo = t >= off, hi = t + off < AFFINE_THREADS;
    if (lo) mont_mul(c, pre + (t - off) * NW, pre + t * NW, p);
    if (hi) mont_mul(c, suf + t * NW, suf + (t + off) * NW, s);
    __syncthreads();
    if (lo) fe_copy(pre + t * NW, p);
    if (hi) fe_copy(suf + t * NW, s);
    __syncthreads();
  }
  u32 others[NW];
  affine_others(c, pre, suf, t, others);
  if (t == 0) fe_inv(c, pre + (AFFINE_THREADS - 1) * NW, inv);
  __syncthreads();
  mont_mul(c, inv, others, q);  // 1 / q
  affine_back(c, X, Y, Z, x, y, n, b, t, q);
}

extern "C" {

// bases_lm: the lane-major (n_lanes, B, 2, 8) bases, 16-byte aligned.
int hp_msm_bucket(const u32* consts, const int* digits, const u32* bases_lm,
                  u32* buckets, int J, int B, int n_lanes, void* stream) {
  if (B > BUCKET_MAX_STEPS || J > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(n_lanes, BUCKET_LANES), J);
  k_msm_bucket<<<grid, BUCKET_LANES, 0, (cudaStream_t)stream>>>(
      load_consts(consts), digits, bases_lm, buckets, B, n_lanes);
  return (int)cudaGetLastError();
}

// partials: (J, S, P, 3, 8) scratch and tickets: J * S zeroed ints, for
// G = merge_group(J, S, n_lanes) > MERGE_THREADS, P = G / MERGE_THREADS
// (unused otherwise).
int hp_msm_merge(const u32* consts, const u32* buckets, u32* reduced,
                 u32* partials, int* tickets, int J, int S, int n_lanes,
                 void* stream) {
  const int G = merge_group(J, S, n_lanes);
  const long long threads = (long long)J * S * G;
  k_msm_merge<<<blocks_for(threads, MERGE_THREADS), MERGE_THREADS, 0,
                (cudaStream_t)stream>>>(load_consts(consts), buckets,
                                        reduced, partials, tickets, J, S,
                                        n_lanes, G);
  return (int)cudaGetLastError();
}

// S <= WSUM_MAX_SLOTS.
int hp_msm_wsum(const u32* consts, const u32* reduced, u32* out, int J,
                int S, void* stream) {
  if (S > WSUM_MAX_SLOTS) return (int)cudaErrorInvalidValue;
  const int G = wsum_group(S);
  k_msm_wsum<<<blocks_for((long long)J * G, WSUM_THREADS), WSUM_THREADS, 0,
               (cudaStream_t)stream>>>(load_consts(consts), reduced, out, S,
                                       J, G);
  return (int)cudaGetLastError();
}

// x is written twice: phase 1 keeps the running products there.
int hp_to_affine(const u32* consts, const u32* X, const u32* Y, const u32* Z,
                 u32* x, u32* y, long long n, void* stream) {
  k_to_affine<<<blocks_for(n, AFFINE_BLOCK), AFFINE_THREADS, 0,
                (cudaStream_t)stream>>>(load_consts(consts), X, Y, Z, x, y,
                                        n);
  return (int)cudaGetLastError();
}

}  // extern "C"
