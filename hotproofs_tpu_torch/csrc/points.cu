// Hopper kernels for points that change with every call: the bases of
// Spartan's inner-product arguments (nova/spartan.py), whose generators are
// folded each round, and its preprocessed matrix tables. Built by nvcc for
// sm_90a into the same shared library as msm.cu (ops/cuda_lib.py), bound
// with ctypes; each launcher runs on the caller's stream, allocates nothing
// and returns cudaGetLastError().
//
// scale16 replaces the reference's scale_points16 (hotproofs_tpu/ops/
//   msm.py:62), an XLA doubling scan: 16^w * P for every window w of the
//   fixed-base MSM (msm.cu), which reads its bases pre-scaled. One thread a
//   point walks the windows in order, 4 complete doublings (9 products
//   each, csrc/curve.cuh) between two stores, and writes words, not
//   digits: at n = 16,384 and 64 windows 67 MB of x, y against 268 MB as
//   the digits the key's disk cache holds. What bounds it: the products,
//   4 (W4 - 1) doublings a point, and the bytes written; one thread runs
//   its doublings one after another, so at a few thousand points (the
//   IPA's later rounds) the latency of that chain sets the time instead.
// fold2 replaces the reference's per-round generator fold (hotproofs_tpu/
//   nova/spartan.py:198-201: two batched uniform-scalar pt_scalar_mul,
//   ops/curve.py:178, and a pt_add): G'_i = x^-1 G_lo[i] + x G_hi[i]. One
//   thread a pair runs Shamir's trick, one joint double-and-add over both
//   scalars (the two scalars are the same for every thread, so the warps
//   never diverge): as many doublings as the highest set bit and one
//   complete add for each bit position where either scalar has a 1, where
//   two separate multiplications double twice as often. What bounds it: the
//   products of the least method (chip_smoke.py fold2_least: each scalar
//   split by the curve's endomorphism, width-w NAFs; about half of this
//   kernel's products), and at the IPA's sizes (h <= 8,192) the latency of
//   each thread's chain of doublings and adds.
#include <cuda_runtime.h>

#include "points.cuh"

using namespace hp;

__global__ void __launch_bounds__(POINT_THREADS)
    k_scale16(Consts c, const u32* __restrict__ pts, u32* __restrict__ out,
              long long n, int windows) {
  const long long i = (long long)blockIdx.x * POINT_THREADS + threadIdx.x;
  if (i < n) scale16_point(c, pts, out, n, i, windows);
}

__global__ void __launch_bounds__(POINT_THREADS)
    k_fold2(Consts c, Scalar xi, Scalar x, int top,
            const u32* __restrict__ G, u32* __restrict__ out, long long h) {
  const long long i = (long long)blockIdx.x * POINT_THREADS + threadIdx.x;
  if (i < h) fold2_point(c, xi, x, top, G, out, h, i);
}

extern "C" {

int hp_scale16(const u32* consts, const u32* pts, u32* out, long long n,
               int windows, void* stream) {
  k_scale16<<<blocks_for(n, POINT_THREADS), POINT_THREADS, 0,
              (cudaStream_t)stream>>>(load_consts(consts), pts, out, n,
                                      windows);
  return (int)cudaGetLastError();
}

// scalars: x^-1 then x, 8 words each, canonical.
int hp_fold2(const u32* consts, const u32* scalars, const u32* G, u32* out,
             long long h, void* stream) {
  Scalar xi, x;
  for (int k = 0; k < NW; ++k) {
    xi.w[k] = scalars[k];
    x.w[k] = scalars[NW + k];
  }
  k_fold2<<<blocks_for(h, POINT_THREADS), POINT_THREADS, 0,
            (cudaStream_t)stream>>>(load_consts(consts), xi, x,
                                    top_bit2(xi, x), G, out, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
