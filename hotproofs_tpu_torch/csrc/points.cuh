// Per-thread body of the variable-base point kernel (points.cu): the
// window scaling of projective points into the MSM's pre-scaled bases. It
// is __host__ __device__ so the CPU tests run the exact per-thread code
// (csrc/host_check.cc, tests/test_torch_cuda_host.py).
//
// Layouts (u32 words, one point a row of 3 x 8 words: X, Y, Z Montgomery):
//   pts (n, 3, 8)        points in
//   out (W4, n, 3, 8)    scale16: 16^w * P_i at [w, i]
#pragma once

#include "msm.cuh"

namespace hp {

constexpr int POINT_THREADS = 128;  // threads per block

// scale16 at point i: out[w, i] = 16^w * P_i for w < windows, by 4
// complete doublings a window (Algorithm 9). The identity stays the
// identity (Z = 0), as the doubling of (0 : 1 : 0) is (0 : 1 : 0).
HP_HD void scale16_point(const Consts& c, const u32* pts, u32* out,
                         long long n, long long i, int windows) {
  Proj p;
  load_proj(pts + (size_t)i * 3 * NW, 1, p);
  for (int w = 0; w < windows; ++w) {
    store_proj(out + ((size_t)w * n + i) * 3 * NW, 1, p);
    if (w + 1 < windows)
      for (int k = 0; k < 4; ++k) pt_double(c, p, p);
  }
}

}  // namespace hp
