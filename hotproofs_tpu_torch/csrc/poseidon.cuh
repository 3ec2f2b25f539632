// Per-thread body of the batched Poseidon permutation (poseidon.cu):
// __host__ __device__, so the CPU tests run it through host_check.cc
// against the host oracle (ops/poseidon.py: host_permute).
//
// A state is T field elements in Montgomery form. It comes in and goes out
// as (n, T, 32) int32 digits, the public format of mont_mul's element-major
// layout (mont.cuh: ld4, pack4), and lives in registers as T x 8 words. The
// round constants (R, T) and the MDS matrix (T, T), Montgomery words, sit
// in one device buffer, rc then mds, which every thread reads at the same
// address. Each round adds its constants, raises every lane (a full round)
// or lane 0 (a partial round) to the fifth power, and multiplies by the
// MDS matrix; which rounds are full follows from the round index (the
// first and last r_full / 2), so no mask is read. The reference computes
// the S-box on every lane and keeps lane 0's in a partial round: the same
// values.
//
// Products run on the lean field backend (field_lean.cuh): x^2 and x^4 are
// its squaring (lean_sqr_wide, then mont_redc<1>), x^5 and the MDS
// products its mont_mul, the sums its fe_add. It needs p < 2^255, true of
// every circuit field.
#pragma once

#include "field_lean.cuh"
#include "mont.cuh"

namespace hp {

// The lean backend's constants for a field alone (no curve): p and n0inv
// from the FieldConsts pack (ops/pallas_field.py: field_consts_words); the
// curve fields, which no Poseidon product reads, are zero.
HP_HD LeanConsts lean_field_consts(const FieldConsts& f) {
  LeanConsts c{};
  for (int i = 0; i < NW; ++i) c.p[i] = f.p[i];
  c.n0inv = f.n0inv;
  return c;
}

// x = x^5.
HP_HD void poseidon_sbox(const LeanConsts& c, u32* x) {
  u32 t[1][2 * NW], x2[NW];
  lean_sqr_wide(x, t[0]);
  mont_redc<1>(c, t);                      // x^2
  fe_copy(x2, t[0]);
  lean_sqr_wide(x2, t[0]);
  mont_redc<1>(c, t);                      // x^4
  mont_mul(c, t[0], x, x);
}

// The permutation of one state s, in place.
template <int T>
HP_HD void poseidon_rounds(const LeanConsts& c, const u32* rc,
                           const u32* mds, int r_full, int r_partial,
                           u32 (&s)[T][NW]) {
  const int half = r_full / 2, rounds = r_full + r_partial;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const u32* k = rc + (size_t)r * T * NW;
#pragma unroll
    for (int i = 0; i < T; ++i) fe_add(c, s[i], k + i * NW, s[i]);
    if (r < half || r >= half + r_partial) {
#pragma unroll
      for (int i = 0; i < T; ++i) poseidon_sbox(c, s[i]);
    } else {
      poseidon_sbox(c, s[0]);
    }
    // out_i = sum_j mds_ij s_j, each entry taken into registers before
    // its product (mont_mul reads its first operand once a word round).
    u32 out[T][NW];
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        u32 m[NW], prod[NW];
        fe_copy(m, mds + (size_t)(i * T + j) * NW);
        mont_mul(c, m, s[j], j == 0 ? out[i] : prod);
        if (j > 0) fe_add(c, out[i], prod, out[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < T; ++i) fe_copy(s[i], out[i]);
  }
}

// Thread i's state: (n, T, 32) digits in, permuted, out.
template <int T>
HP_HD void poseidon_elem(const LeanConsts& c, const u32* rc_mds, int r_full,
                         int r_partial, const int* in, int* out, size_t i) {
  u32 s[T][NW];
  const int* a = in + i * T * ND;
#pragma unroll
  for (int l = 0; l < T; ++l) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      Int4 v = ld4(a + l * ND + 4 * k);
      s[l][k] = pack4(v.x, v.y, v.z, v.w);
    }
  }
  const u32* mds = rc_mds + (size_t)(r_full + r_partial) * T * NW;
  poseidon_rounds<T>(c, rc_mds, mds, r_full, r_partial, s);
  int* o = out + i * T * ND;
#pragma unroll
  for (int l = 0; l < T; ++l) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const u32 w = s[l][k];
      st4(o + l * ND + 4 * k,
          Int4{(int)(w & 0xFFu), (int)((w >> 8) & 0xFFu),
               (int)((w >> 16) & 0xFFu), (int)(w >> 24)});
    }
  }
}

}  // namespace hp
