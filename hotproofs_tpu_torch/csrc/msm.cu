// Hopper kernels of the commitment path: the MSM chain bucket -> merge ->
// wsum, and the key preparation to_affine. Built by nvcc for sm_90a into a
// shared library with a plain C interface (ops/cuda_lib.py), bound with
// ctypes. Each launcher runs on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// K1 msm_bucket replaces _bucket_kernel (hotproofs_tpu/ops/msm_pallas.py:210).
//   One thread per (job, lane) streams its B affine bases and mixed-adds each
//   into one of 15 projective buckets picked by its radix-16 digit. Bound by
//   integer multiply throughput: each base costs one 11-multiply RCB15 mixed
//   add (~11 x 128 32-bit multiply-adds). The bases are time-major, so at
//   each step a warp reads 32 consecutive words per coordinate word
//   (coalesced); the 15 buckets (1.4 KB) live in thread-local memory, which
//   L1 caches. All J jobs read the same base array.
// K2 msm_merge replaces _merge_kernel (msm_pallas.py:288).
//   One 256-thread block per (job, slot): each thread adds a strided subset
//   of lanes, then a shared-memory halving tree. Bound by the serial
//   complete-add chain per thread (n_lanes / 256 adds, then 8 tree levels).
// K3 msm_wsum replaces _wsum_kernel (msm_pallas.py:358).
//   One thread per job: 30 complete adds of the running suffix sum. Latency
//   bound and tiny; it exists so the chain never leaves the device.
// K4 to_affine replaces _inv_kernel / batch_inv_mont_lm (msm_pallas.py:66,
//   88) and _mont_mul_kernel / mont_mul_lm (pallas_field.py:267, 296) as
//   scaled_affine_device composes them (msm_pallas.py:156-170): one thread
//   per point computes z^(p-2) (256 squarings + ~128 multiplies) and then
//   x/z, y/z. Bound by multiply throughput; it runs once per key.
#include <cuda_runtime.h>

#include "msm.cuh"

using namespace hp;

__global__ void k_msm_bucket(Consts c, const int* __restrict__ digits,
                             const u32* __restrict__ bases,
                             u32* __restrict__ buckets, int J, int B,
                             int n_lanes) {
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)J * n_lanes) return;
  int j = (int)(gid / n_lanes);
  int l = (int)(gid % n_lanes);
  bucket_lane(c, digits, bases, buckets, B, n_lanes, j, l);
}

__global__ void __launch_bounds__(MERGE_THREADS)
    k_msm_merge(Consts c, const u32* __restrict__ buckets,
                u32* __restrict__ reduced, int n_lanes) {
  __shared__ Proj sh[MERGE_THREADS];
  const int js = blockIdx.x;
  const int j = js / NBUCKET, s = js % NBUCKET;
  const int tid = threadIdx.x;
  Proj acc;
  merge_thread(c, buckets, n_lanes, j, s, tid, MERGE_THREADS, acc);
  sh[tid] = acc;
  __syncthreads();
  for (int h = MERGE_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) {
      Proj a = sh[tid];
      Proj b = sh[tid + h];
      pt_add(c, a, b, a);
      sh[tid] = a;
    }
    __syncthreads();
  }
  if (tid == 0) store_proj(reduced + (size_t)js * 3 * NW, 1, sh[0]);
}

__global__ void k_msm_wsum(Consts c, const u32* __restrict__ reduced,
                           u32* __restrict__ out, int J) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < J) wsum_job(c, reduced, out, j);
}

__global__ void k_to_affine(Consts c, const u32* __restrict__ X,
                            const u32* __restrict__ Y,
                            const u32* __restrict__ Z, u32* __restrict__ x,
                            u32* __restrict__ y, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) affine_point(c, X, Y, Z, x, y, (size_t)i);
}

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

extern "C" {

int hp_msm_bucket(const u32* consts, const int* digits, const u32* bases,
                  u32* buckets, int J, int B, int n_lanes, void* stream) {
  const int threads = 128;
  long long n = (long long)J * n_lanes;
  k_msm_bucket<<<blocks_for(n, threads), threads, 0,
                 (cudaStream_t)stream>>>(load_consts(consts), digits, bases,
                                         buckets, J, B, n_lanes);
  return (int)cudaGetLastError();
}

int hp_msm_merge(const u32* consts, const u32* buckets, u32* reduced, int J,
                 int n_lanes, void* stream) {
  k_msm_merge<<<J * NBUCKET, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      load_consts(consts), buckets, reduced, n_lanes);
  return (int)cudaGetLastError();
}

int hp_msm_wsum(const u32* consts, const u32* reduced, u32* out, int J,
                void* stream) {
  const int threads = 32;
  k_msm_wsum<<<blocks_for(J, threads), threads, 0, (cudaStream_t)stream>>>(
      load_consts(consts), reduced, out, J);
  return (int)cudaGetLastError();
}

int hp_to_affine(const u32* consts, const u32* X, const u32* Y, const u32* Z,
                 u32* x, u32* y, long long n, void* stream) {
  const int threads = 128;
  k_to_affine<<<blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      load_consts(consts), X, Y, Z, x, y, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
