// Hopper kernel that scales projective points into the MSM's pre-scaled
// bases: a key's generators when the key is prepared (nova/pedersen.py)
// and Spartan's preprocessed matrix tables (nova/spartan.py). Built by nvcc for
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
//   its doublings one after another, so at a few tens of thousands of
//   points (the key's 16,384, the tables' 49,152) the latency of that
//   chain sets the time instead.
#include <cuda_runtime.h>

#include "points.cuh"

using namespace hp;

__global__ void __launch_bounds__(POINT_THREADS)
    k_scale16(Consts c, const u32* __restrict__ pts, u32* __restrict__ out,
              long long n, int windows) {
  const long long i = (long long)blockIdx.x * POINT_THREADS + threadIdx.x;
  if (i < n) scale16_point(c, pts, out, n, i, windows);
}

extern "C" {

int hp_scale16(const u32* consts, const u32* pts, u32* out, long long n,
               int windows, void* stream) {
  k_scale16<<<blocks_for(n, POINT_THREADS), POINT_THREADS, 0,
              (cudaStream_t)stream>>>(load_consts(consts), pts, out, n,
                                      windows);
  return (int)cudaGetLastError();
}

}  // extern "C"
