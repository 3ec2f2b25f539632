// Per-thread body of the variable-base point kernel (points.cu): the
// window scaling of projective points into the MSM's pre-scaled bases. It
// is __host__ __device__ so the CPU tests run the exact per-thread code
// (csrc/host_check.cc, tests/test_torch_cuda_host.py).
//
// Layouts (u32 words, one point a row of 3 x 8 words: X, Y, Z Montgomery):
//   pts (n, 3, 8)        points in, homogeneous (x = X / Z, y = Y / Z)
//   out (W4, n, 3, 8)    scale16: 16^w * P_i at [w, i], homogeneous
#pragma once

#include "field_lean.cuh"
#include "msm.cuh"

namespace hp {

constexpr int POINT_THREADS = 128;  // threads per block

// (X, Y, Z) = 2 (X, Y, Z) in Jacobian coordinates (x = X / Z^2, y = Y /
// Z^3) on a curve with a = 0: dbl-2009-l, 2 products and 5 squarings,
//   A = X^2, B = Y^2, C = B^2, D = 2 ((X + B)^2 - A - C), E = 3A, F = E^2,
//   X3 = F - 2D, Y3 = E (D - X3) - 8C, Z3 = 2 Y Z.
// The products fall into three levels of independent ones, {A, B, Y Z},
// {C, (X + B)^2, F} and {E (D - X3)}; each level's wide products are
// reduced together (mont_redc), so a thread has three carry chains in
// flight where it would run seven one after another. It has no case for
// the identity, which it maps from (0, 0, 0) to itself, and none for y =
// 0, which no point of a prime-order curve but the identity has.
HP_HD void jac_double(const LeanConsts& c, u32* X, u32* Y, u32* Z) {
  u32 t[3][2 * NW], A[NW], B[NW], C[NW], D[NW], E[NW];
  lean_sqr_wide(X, t[0]);
  lean_sqr_wide(Y, t[1]);
  lean_mul_wide(Y, Z, t[2]);
  mont_redc<3>(c, t);
  fe_copy(A, t[0]);
  fe_copy(B, t[1]);
  fe_add(c, t[2], t[2], Z);                   // Z3 = 2 Y Z
  fe_add(c, X, B, D);
  fe_add(c, A, A, E);
  fe_add(c, E, A, E);
  lean_sqr_wide(B, t[0]);
  lean_sqr_wide(D, t[1]);
  lean_sqr_wide(E, t[2]);
  mont_redc<3>(c, t);
  fe_copy(C, t[0]);
  fe_sub(c, t[1], A, D);
  fe_sub(c, D, C, D);
  fe_add(c, D, D, D);                         // D
  fe_add(c, D, D, B);
  fe_sub(c, t[2], B, X);                      // X3 = F - 2D
  fe_sub(c, D, X, B);
  mont_mul(c, E, B, Y);
  fe_add(c, C, C, C);
  fe_add(c, C, C, C);
  fe_add(c, C, C, C);
  fe_sub(c, Y, C, Y);                         // Y3 = E (D - X3) - 8C
}

// The homogeneous form of Jacobian (X, Y, Z), (X Z, Y, Z^3), stored at
// row `at`; Z = 0 (the identity) is stored as (0 : 1 : 0), 1 in
// Montgomery form, the identity every other kernel writes.
HP_HD void store_jac(const LeanConsts& c, const u32* X, const u32* Y,
                     const u32* Z, u32* at) {
  u32 t[2][2 * NW];
  lean_sqr_wide(Z, t[0]);
  lean_mul_wide(X, Z, t[1]);
  mont_redc<2>(c, t);
  mont_mul(c, t[0], Z, at + 2 * NW);
  fe_copy(at, t[1]);
  const bool inf = fe_is_zero(Z);
#pragma unroll
  for (int k = 0; k < NW; ++k) at[NW + k] = inf ? c.one[k] : Y[k];
}

// Point i in Jacobian form, (X Z, Y Z^2, Z) of its homogeneous words.
HP_HD void load_jac(const LeanConsts& c, const u32* pts, long long i, u32* X,
                    u32* Y, u32* Z) {
  const u32* in = pts + (size_t)i * 3 * NW;
  u32 t[2][2 * NW];
  fe_copy(Z, in + 2 * NW);
  lean_sqr_wide(Z, t[0]);
  lean_mul_wide(in, Z, t[1]);
  mont_redc<2>(c, t);
  fe_copy(X, t[1]);
  mont_mul(c, in + NW, t[0], Y);
}

// scale16 at point i: out[w, i] = 16^w * P_i for w < windows. The point
// enters Jacobian form once; between two stored windows it takes 4
// Jacobian doublings. A point with Z = 0 stays (0, 0, 0) and is stored as
// (0 : 1 : 0) at every window.
HP_HD void scale16_point(const LeanConsts& c, const u32* pts, u32* out,
                         long long n, long long i, int windows) {
  u32 X[NW], Y[NW], Z[NW];
  load_jac(c, pts, i, X, Y, Z);
  for (int w = 0; w < windows; ++w) {
    store_jac(c, X, Y, Z, out + ((size_t)w * n + i) * 3 * NW);
    if (w + 1 < windows) {
#pragma unroll 1
      for (int k = 0; k < 4; ++k) jac_double(c, X, Y, Z);
    }
  }
}

}  // namespace hp
