// Per-thread bodies of the variable-base point kernels (points.cu): the
// window scaling of projective points for the MSM over bases that change
// with every call, and the inner-product argument's generator fold. They
// are __host__ __device__ so the CPU tests run the exact per-thread code
// (csrc/host_check.cc, tests/test_torch_cuda_host.py).
//
// Layouts (u32 words, one point a row of 3 x 8 words: X, Y, Z Montgomery):
//   pts (n, 3, 8)        points in
//   out (W4, n, 3, 8)    scale16: 16^w * P_i at [w, i]
//   G   (2h, 3, 8)       fold2: G_lo = rows [0, h), G_hi = rows [h, 2h)
//   out (h, 3, 8)        fold2: x^-1 * G_lo[i] + x * G_hi[i]
#pragma once

#include "msm.cuh"

namespace hp {

constexpr int POINT_THREADS = 128;  // threads per block of both kernels

// A 256-bit scalar as 8 little-endian words (canonical, not Montgomery).
struct Scalar {
  u32 w[NW];
};

HP_HD bool scalar_bit(const Scalar& k, int i) {
  return (k.w[i >> 5] >> (i & 31)) & 1u;
}

// The highest bit set in a or b, -1 if both are 0.
HP_HD int top_bit2(const Scalar& a, const Scalar& b) {
  for (int i = 8 * sizeof(u32) * NW - 1; i >= 0; --i)
    if (scalar_bit(a, i) || scalar_bit(b, i)) return i;
  return -1;
}

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

// fold2 at point i: xi * G_lo[i] + x * G_hi[i] by Shamir's trick, one
// double-and-add over the bits of both scalars from the highest set one
// down: double, then add G_lo, G_hi or their sum (made once) where the
// bits of xi, x select it. Complete adds throughout, so an identity among
// the points or a zero scalar needs no branch. The result is the same
// group element as the reference's two scalar multiplications and an add;
// its projective coordinates may differ, and every consumer goes through
// an affine conversion.
HP_HD void fold2_point(const Consts& c, const Scalar& xi, const Scalar& x,
                       int top, const u32* G, u32* out, long long h,
                       long long i) {
  Proj lo, hi, both, acc;
  load_proj(G + (size_t)i * 3 * NW, 1, lo);
  load_proj(G + (size_t)(h + i) * 3 * NW, 1, hi);
  pt_add(c, lo, hi, both);
  pt_identity(c, acc);
  for (int b = top; b >= 0; --b) {
    pt_double(c, acc, acc);
    const bool bl = scalar_bit(xi, b), bh = scalar_bit(x, b);
    // One call site of the add (its inlined body is most of the code),
    // its operand picked word by word so that all three stay in
    // registers.
    Proj q;
    for (int k = 0; k < NW; ++k) {
      q.x[k] = bl ? (bh ? both.x[k] : lo.x[k]) : hi.x[k];
      q.y[k] = bl ? (bh ? both.y[k] : lo.y[k]) : hi.y[k];
      q.z[k] = bl ? (bh ? both.z[k] : lo.z[k]) : hi.z[k];
    }
    if (bl || bh) pt_add(c, acc, q, acc);
  }
  store_proj(out + (size_t)i * 3 * NW, 1, acc);
}

}  // namespace hp
