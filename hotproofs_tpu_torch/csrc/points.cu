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
//   point walks the windows in order and writes words, not digits: at n =
//   16,384 and 64 windows 67 MB of x, y against 268 MB as the digits the
//   key's disk cache holds. What bounds it: the products, 4 (W4 - 1)
//   doublings a point and a conversion a window, and the bytes written;
//   one thread runs its doublings one after another, so at a few tens of
//   thousands of points (the key's 16,384, the tables' 49,152) the latency
//   of that chain sets the time instead. The design shortens the chain:
//   the doublings are Jacobian (2 products and 5 squarings where the
//   complete formula of curve.cuh takes 9 products), on the lean field
//   backend (field_lean.cuh: PTX carry chains, the squaring with each
//   cross product once), and the point leaves Jacobian form only at a
//   store (points.cuh). A doubling's 7 products fall into 3 levels of
//   independent ones, and each level's are reduced side by side, so a
//   thread keeps up to 3 carry chains in flight: at the key's 16,384
//   points the card holds one warp a scheduler, and the chain's latency,
//   not the multiply pipe, would set the time. (Two threads a point, each
//   taking half of a level's products, ran slower: the halves are
//   different code, which a warp runs one after the other; PERF.md.) The
//   homogeneous words it writes differ from the complete formula's; the
//   points, and so everything that reads them (to_affine, the MSM), do
//   not.
#include <cuda_runtime.h>

#include "points.cuh"

using namespace hp;

// 3 blocks an SM (at most 170 registers a thread) keep the tables' 49,152
// points (384 blocks) in one wave on 132 SMs.
__global__ void __launch_bounds__(POINT_THREADS, 3)
    k_scale16(LeanConsts c, const u32* __restrict__ pts,
              u32* __restrict__ out, long long n, int windows) {
  const long long i = (long long)blockIdx.x * POINT_THREADS + threadIdx.x;
  if (i < n) scale16_point(c, pts, out, n, i, windows);
}

extern "C" {

// lean_consts: LeanConsts' words (ops/msm_pallas.py: lean_consts_words).
int hp_scale16(const u32* lean_consts, const u32* pts, u32* out, long long n,
               int windows, void* stream) {
  k_scale16<<<blocks_for(n, POINT_THREADS), POINT_THREADS, 0,
              (cudaStream_t)stream>>>(load_lean_consts(lean_consts), pts,
                                      out, n, windows);
  return (int)cudaGetLastError();
}

}  // extern "C"
