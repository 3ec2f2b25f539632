// The lean field backend of the point formulas (curve.cuh), taken by the
// kernels that are nothing but point arithmetic: msm_chain (msm_designs.cu)
// and h_tables (tables.cu), whose mixed adds it runs, and scale16
// (points.cu), whose Jacobian doublings take its squaring (lean_sqr_wide:
// 36 word products where a product has 64) and its wide products reduced
// in batches (mont_redc<K>: a squaring 208 multiplies in all, a product
// 264, as mont_mul).
// Every other kernel keeps field.cuh's C++.
//
// The formulas are templates on the constants' type: with Consts they call
// field.cuh's mont_mul, fe_add and fe_sub; with LeanConsts the overloads
// below, which on the card are PTX carry chains:
//   * mont_mul: CIOS with mad.lo.cc / madc.hi.cc chains, two per word of b
//     (the products' low halves into t[0..7], their high halves into
//     t[1..8]) and two for the reduction, one mul.lo for its factor, in
//     place of 64-bit C++ products whose carries are shifted out word by
//     word; then one branch-free conditional subtract. The loop over b's
//     words stays rolled (b rotated through registers): one round of code
//     a product instead of eight. Unrolled, a mixed add was 6,725 SASS
//     instructions and h_tables, whose warps stand in the walk's add and
//     in the join's complete adds at once, spent 1.8x the chain's SM
//     cycles a warp-step; rolled, the add is 1,813 instructions and
//     h_tables ran 20.1 ms where the unrolled took 34.0 (an H100, one
//     run of tools/designs_ab.py; PERF.md): instruction fetch, not the
//     multiplies, held it;
//   * fe_add, fe_sub: one add (sub) chain, one chain against p, and a
//     select by the last borrow, in place of geq_p's branching compare;
//   * the two products by 3b of Algorithm 8 (and 9 of Algorithm 7) as a
//     few modular doublings and additions: 3b is 15 on Pallas and Vesta, 9
//     on BN254 and -51 on Grumpkin (LeanConsts::b3k).
// Every value stays canonical (< p), so the results are field.cuh's bit
// for bit. The chains take p < 2^255 (true of the four fields): then t +
// a b_i + m p < p 2^33 < 2^288 fits t[0..8] in every CIOS round and a + b
// never carries out of 8 words. The Pasta primes exceed 2^254, so the
// lazy [0, 2p) form would not fit 8 words; nothing here is lazy.
//
// Under g++ (host_check.cc) the overloads are field.cuh's C++ and the
// small-constant product is the same code as on the card: the CPU tests
// check the formulas and the constant's chain; the card checks the PTX
// against the plain versions.
#pragma once

#include "field.cuh"

namespace hp {

// Consts and 3b as a small signed integer, packed by
// hotproofs_tpu_torch/ops/msm_pallas.py: lean_consts_words (Consts' 33
// words, then b3k).
struct LeanConsts : Consts {
  int b3k;
};

HP_HD LeanConsts load_lean_consts(const u32* w) {
  LeanConsts c;
  static_cast<Consts&>(c) = load_consts(w);
  c.b3k = (int)w[CONSTS_WORDS];
  return c;
}

#ifdef __CUDA_ARCH__
// out = a < p ? a : a - p: one subtract chain, then a select on its borrow.
__device__ __forceinline__ void lean_reduce_once(const u32* p, const u32* a,
                                                 u32* out) {
  u32 s[NW], m;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(m)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]),
        "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]));
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = (a[i] & m) | (s[i] & ~m);
}

// t[0..8] += a * bi: the low halves into t[0..7] (carry into t[8]), then
// the high halves into t[1..8].
__device__ __forceinline__ void lean_mac_row(u32* t, const u32* a, u32 bi) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(bi));
  asm("mad.hi.cc.u32 %0, %8, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
      "madc.hi.u32 %7, %15, %16, %7;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(bi));
}
#endif  // __CUDA_ARCH__

// out = a * b * 2^-256 mod p (canonical in and out; out may alias).
HP_HD void mont_mul(const LeanConsts& c, const u32* a, const u32* b,
                    u32* out) {
#ifdef __CUDA_ARCH__
  u32 t[NW + 1], bb[NW];
#pragma unroll
  for (int j = 0; j <= NW; ++j) t[j] = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) bb[j] = b[j];
#pragma unroll 1
  for (int i = 0; i < NW; ++i) {
    lean_mac_row(t, a, bb[0]);
    lean_mac_row(t, c.p, t[0] * c.n0inv);   // t[0] becomes 0
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
    t[NW] = 0;
#pragma unroll
    for (int j = 0; j + 1 < NW; ++j) bb[j] = bb[j + 1];
  }
  lean_reduce_once(c.p, t, out);
#else
  mont_mul(static_cast<const Consts&>(c), a, b, out);
#endif
}

// out = a + b mod p (canonical in, canonical out; out may alias).
HP_HD void fe_add(const LeanConsts& c, const u32* a, const u32* b,
                  u32* out) {
#ifdef __CUDA_ARCH__
  u32 r[NW];
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  lean_reduce_once(c.p, r, out);
#else
  fe_add(static_cast<const Consts&>(c), a, b, out);
#endif
}

// out = a - b mod p (canonical in, canonical out; out may alias).
HP_HD void fe_sub(const LeanConsts& c, const u32* a, const u32* b,
                  u32* out) {
#ifdef __CUDA_ARCH__
  u32 r[NW], q[NW], m;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(m)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3]), "=r"(q[4]),
        "=r"(q[5]), "=r"(q[6]), "=r"(q[7])
      : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(r[4]), "r"(r[5]),
        "r"(r[6]), "r"(r[7]), "r"(c.p[0]), "r"(c.p[1]), "r"(c.p[2]),
        "r"(c.p[3]), "r"(c.p[4]), "r"(c.p[5]), "r"(c.p[6]), "r"(c.p[7]));
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = (q[i] & m) | (r[i] & ~m);
#else
  fe_sub(static_cast<const Consts&>(c), a, b, out);
#endif
}

#ifdef __CUDA_ARCH__
// t[1..14] = the 28 cross products a_i a_j (i < j) at word i + j, row by
// row: row i's low halves into t[2i+1 .. i+7] with the carry into t[i+8]
// (zero until then), its high halves into t[2i+2 .. i+8]. After row i the
// sum is below 2^(32 (i+9)), so the last high half carries out nothing.
__device__ __forceinline__ void lean_sqr_cross(u32* t, const u32* a) {
  asm(
      "mad.lo.cc.u32 %0, %14, %15, %0;\n\t"
      "madc.lo.cc.u32 %1, %14, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %14, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %19, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %20, %5;\n\t"
      "madc.lo.cc.u32 %6, %14, %21, %6;\n\t"
      "addc.u32 %7, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %14, %15, %1;\n\t"
      "madc.hi.cc.u32 %2, %14, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %19, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %20, %6;\n\t"
      "madc.hi.u32 %7, %14, %21, %7;\n\t"
      "mad.lo.cc.u32 %2, %15, %16, %2;\n\t"
      "madc.lo.cc.u32 %3, %15, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %20, %6;\n\t"
      "madc.lo.cc.u32 %7, %15, %21, %7;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.hi.cc.u32 %3, %15, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %15, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %20, %7;\n\t"
      "madc.hi.u32 %8, %15, %21, %8;\n\t"
      "mad.lo.cc.u32 %4, %16, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %16, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %20, %7;\n\t"
      "madc.lo.cc.u32 %8, %16, %21, %8;\n\t"
      "addc.u32 %9, 0, 0;\n\t"
      "mad.hi.cc.u32 %5, %16, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
      "madc.hi.cc.u32 %8, %16, %20, %8;\n\t"
      "madc.hi.u32 %9, %16, %21, %9;\n\t"
      "mad.lo.cc.u32 %6, %17, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %20, %8;\n\t"
      "madc.lo.cc.u32 %9, %17, %21, %9;\n\t"
      "addc.u32 %10, 0, 0;\n\t"
      "mad.hi.cc.u32 %7, %17, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %19, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %20, %9;\n\t"
      "madc.hi.u32 %10, %17, %21, %10;\n\t"
      "mad.lo.cc.u32 %8, %18, %19, %8;\n\t"
      "madc.lo.cc.u32 %9, %18, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %21, %10;\n\t"
      "addc.u32 %11, 0, 0;\n\t"
      "mad.hi.cc.u32 %9, %18, %19, %9;\n\t"
      "madc.hi.cc.u32 %10, %18, %20, %10;\n\t"
      "madc.hi.u32 %11, %18, %21, %11;\n\t"
      "mad.lo.cc.u32 %10, %19, %20, %10;\n\t"
      "madc.lo.cc.u32 %11, %19, %21, %11;\n\t"
      "addc.u32 %12, 0, 0;\n\t"
      "mad.hi.cc.u32 %11, %19, %20, %11;\n\t"
      "madc.hi.u32 %12, %19, %21, %12;\n\t"
      "mad.lo.cc.u32 %12, %20, %21, %12;\n\t"
      "addc.u32 %13, 0, 0;\n\t"
      "mad.hi.u32 %13, %20, %21, %13;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]),
        "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]));
}

// t[0..15] = 2 t + sum a_i^2 at word 2i (t[0] = t[15] = 0 on entry): the
// doubling's carry out of t[14] lands in t[15]; a^2 < 2^512 carries out
// nothing.
__device__ __forceinline__ void lean_sqr_diag(u32* t, const u32* a) {
  asm(
      "add.cc.u32 %1, %1, %1;\n\t"
      "addc.cc.u32 %2, %2, %2;\n\t"
      "addc.cc.u32 %3, %3, %3;\n\t"
      "addc.cc.u32 %4, %4, %4;\n\t"
      "addc.cc.u32 %5, %5, %5;\n\t"
      "addc.cc.u32 %6, %6, %6;\n\t"
      "addc.cc.u32 %7, %7, %7;\n\t"
      "addc.cc.u32 %8, %8, %8;\n\t"
      "addc.cc.u32 %9, %9, %9;\n\t"
      "addc.cc.u32 %10, %10, %10;\n\t"
      "addc.cc.u32 %11, %11, %11;\n\t"
      "addc.cc.u32 %12, %12, %12;\n\t"
      "addc.cc.u32 %13, %13, %13;\n\t"
      "addc.cc.u32 %14, %14, %14;\n\t"
      "addc.u32 %15, 0, 0;\n\t"
      "mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
        "+r"(t[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]));
}
#endif  // __CUDA_ARCH__

// t[0..15] = a^2, the square's 36 distinct word products: each cross
// product once (2 x 28 multiplies), doubled, plus the 8 squares.
HP_HD void lean_sqr_wide(const u32* a, u32* t) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) t[j] = 0;
  lean_sqr_cross(t, a);
  lean_sqr_diag(t, a);
#else
  for (int j = 0; j < 2 * NW; ++j) t[j] = 0;
  for (int i = 0; i + 1 < NW; ++i) {        // the cross products, row i
    u64 carry = 0;
    for (int j = i + 1; j < NW; ++j) {
      u64 s = (u64)a[i] * a[j] + t[i + j] + carry;
      t[i + j] = (u32)s;
      carry = s >> 32;
    }
    t[i + NW] = (u32)carry;
  }
  for (int j = 2 * NW - 1; j > 0; --j)      // doubled
    t[j] = (t[j] << 1) | (t[j - 1] >> 31);
  u64 carry = 0;
  for (int i = 0; i < NW; ++i) {            // plus the squares
    u64 sq = (u64)a[i] * a[i];
    u64 s = (u64)t[2 * i] + (u32)sq + carry;
    t[2 * i] = (u32)s;
    s = (u64)t[2 * i + 1] + (sq >> 32) + (s >> 32);
    t[2 * i + 1] = (u32)s;
    carry = s >> 32;
  }
#endif
}

// t[0..15] = a b, row i the products a b_i at words i .. i + 8 (after row
// i the sum is below 2^(32 (i+9)), so each row's last high half carries
// out nothing): 2 x 64 multiplies.
HP_HD void lean_mul_wide(const u32* a, const u32* b, u32* t) {
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) t[j] = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < NW; ++i) lean_mac_row(t + i, a, b[i]);
#else
  for (int i = 0; i < NW; ++i) {
    u64 carry = 0;
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)a[j] * b[i] + t[i + j] + carry;
      t[i + j] = (u32)s;
      carry = s >> 32;
    }
    t[i + NW] = (u32)carry;
  }
#endif
}

// The Montgomery reductions of K products T_k = t[k][0..15] (each below
// p 2^256) together: t[k][0..7] = T_k 2^-256 mod p, canonical. mont_mul's
// rolled round on the low half alone, K rounds side by side in each pass
// of the loop (8 + 2 x 64 multiplies a product), so the K carry chains are
// independent work for the scheduler; T = T_lo + T_hi 2^256, the rounds
// make (T_lo + M p) / 2^256 <= p from T_lo alone (M depends on nothing
// else) and T_hi < p, so their sum is below 2p < 2^256 and one conditional
// subtract ends it.
template <int K>
HP_HD void mont_redc(const LeanConsts& c, u32 (&t)[K][2 * NW]) {
  u32 u[K][NW + 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < NW; ++j) u[k][j] = t[k][j];
    u[k][NW] = 0;
  }
#ifdef __CUDA_ARCH__
#pragma unroll 1
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lean_mac_row(u[k], c.p, u[k][0] * c.n0inv);   // u[k][0] becomes 0
#pragma unroll
      for (int j = 0; j < NW; ++j) u[k][j] = u[k][j + 1];
      u[k][NW] = 0;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) fe_add(c, u[k], t[k] + NW, t[k]);
#else
  for (int k = 0; k < K; ++k) {
    for (int i = 0; i < NW; ++i) {
      const u32 m = u[k][0] * c.n0inv;
      u64 cy = 0;
      for (int j = 0; j < NW; ++j) {
        u64 s = (u64)m * c.p[j] + u[k][j] + cy;
        u[k][j] = (u32)s;
        cy = s >> 32;
      }
      u[k][NW] += (u32)cy;
      for (int j = 0; j < NW; ++j) u[k][j] = u[k][j + 1];
      u[k][NW] = 0;
    }
    u64 cy = 0;                             // + T_hi, below 2p
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)u[k][j] + t[k][NW + j] + cy;
      u[k][j] = (u32)s;
      cy = s >> 32;
    }
    if (geq_p(u[k], c.p)) sub_p(u[k], c.p);
    fe_copy(t[k], u[k]);
  }
#endif
}

// out = 3b x (Montgomery in, Montgomery out: the product of 3b's
// Montgomery form with x, as mont_mul(c, c.b3, x) gives it): |b3k| by
// doubling and adding over its bits from the top, then a negation where
// b3k < 0. Pallas and Vesta: 3 doublings and 3 additions; BN254: 3 and 1;
// Grumpkin: 5 and 3, and the negation. The bits are the same for the
// whole warp, so nothing diverges.
HP_HD void mul_b3(const LeanConsts& c, const u32* x, u32* out) {
  const int k = c.b3k < 0 ? -c.b3k : c.b3k;
  int top = 0;
  while ((k >> (top + 1)) != 0) ++top;
  u32 acc[NW];
  fe_copy(acc, x);
#pragma unroll 1
  for (int i = top - 1; i >= 0; --i) {
    fe_add(c, acc, acc, acc);
    if ((k >> i) & 1) fe_add(c, acc, x, acc);
  }
  if (c.b3k < 0) {
    u32 zero[NW];
    fe_zero(zero);
    fe_sub(c, zero, acc, acc);
  }
  fe_copy(out, acc);
}

}  // namespace hp
