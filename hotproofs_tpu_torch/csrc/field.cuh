// 256-bit prime-field arithmetic on 8 little-endian u32 words, Montgomery
// form with R = 2^256. Port of the device field helpers of the JAX package
// (hotproofs_tpu/ops/pallas_field.py: mont_mul_rows, add_rows, sub_rows),
// using the CIOS multiply of native/ffec.cc:62 at 32-bit word width.
//
// Every function is __host__ __device__ under nvcc and plain inline C++
// under g++, so the CPU tests build this header into a ctypes library and
// hold it against the Python oracles (tests/test_torch_cuda_host.py).
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define HP_HD __host__ __device__ __forceinline__
#else
#define HP_HD static inline
#endif

namespace hp {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int NW = 8;  // words per field element

// Constants of one curve's base field, packed by the Python wrapper in this
// order (hotproofs_tpu_torch/ops/msm_pallas.py: consts_words).
struct Consts {
  u32 p[NW];
  u32 one[NW];   // R mod p (Montgomery 1)
  u32 pm2[NW];   // p - 2, the Fermat inversion exponent
  u32 b3[NW];    // 3 * b in Montgomery form (curve constant)
  u32 n0inv;     // -p^-1 mod 2^32
};
constexpr int CONSTS_WORDS = 4 * NW + 1;

HP_HD Consts load_consts(const u32* w) {
  Consts c;
  for (int i = 0; i < NW; ++i) {
    c.p[i] = w[i];
    c.one[i] = w[NW + i];
    c.pm2[i] = w[2 * NW + i];
    c.b3[i] = w[3 * NW + i];
  }
  c.n0inv = w[4 * NW];
  return c;
}

// Constants of one prime field alone, for the field-multiply kernels
// (mont.cuh), which run in any FieldSpec's field and need no curve: p,
// mu = -p^-1 mod 2^256 (the staged reduction's factor) and n0inv, packed
// by hotproofs_tpu_torch/ops/pallas_field.py: field_consts_words.
struct FieldConsts {
  u32 p[NW];
  u32 mu[NW];
  u32 n0inv;     // -p^-1 mod 2^32 (the low word of mu)
};
constexpr int FIELD_CONSTS_WORDS = 2 * NW + 1;

HP_HD FieldConsts load_field_consts(const u32* w) {
  FieldConsts f;
  for (int i = 0; i < NW; ++i) {
    f.p[i] = w[i];
    f.mu[i] = w[NW + i];
  }
  f.n0inv = w[2 * NW];
  return f;
}

HP_HD void fe_copy(u32* out, const u32* a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = a[i];
}

HP_HD void fe_zero(u32* out) {
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = 0;
}

HP_HD bool fe_is_zero(const u32* a) {
  u32 acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a[i];
  return acc == 0;
}

HP_HD bool geq_p(const u32* t, const u32* p) {
  for (int i = NW - 1; i >= 0; --i) {
    if (t[i] != p[i]) return t[i] > p[i];
  }
  return true;
}

HP_HD void sub_p(u32* t, const u32* p) {
  u64 borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 d = (u64)t[i] - p[i] - borrow;
    t[i] = (u32)d;
    borrow = d >> 63;
  }
}

// out = a * b * 2^-256 mod p. Inputs canonical (< p); out may alias a or b.
// K is Consts or FieldConsts: only p and n0inv are read.
template <class K>
HP_HD void mont_mul(const K& c, const u32* a, const u32* b, u32* out) {
  u32 t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)a[j] * b[i] + t[j] + carry;
      t[j] = (u32)s;
      carry = s >> 32;
    }
    u64 s = (u64)t[NW] + carry;
    t[NW] = (u32)s;
    t[NW + 1] = (u32)(s >> 32);
    u32 m = t[0] * c.n0inv;
    carry = ((u64)m * c.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (u64)m * c.p[j] + t[j] + carry;
      t[j - 1] = (u32)s;
      carry = s >> 32;
    }
    s = (u64)t[NW] + carry;
    t[NW - 1] = (u32)s;
    t[NW] = t[NW + 1] + (u32)(s >> 32);
  }
  if (t[NW] || geq_p(t, c.p)) sub_p(t, c.p);
  fe_copy(out, t);
}

// out = a + b mod p (canonical in, canonical out; out may alias).
HP_HD void fe_add(const Consts& c, const u32* a, const u32* b, u32* out) {
  u32 t[NW];
  u64 carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 s = (u64)a[i] + b[i] + carry;
    t[i] = (u32)s;
    carry = s >> 32;
  }
  if (carry || geq_p(t, c.p)) sub_p(t, c.p);
  fe_copy(out, t);
}

// out = a - b mod p (canonical in, canonical out; out may alias).
HP_HD void fe_sub(const Consts& c, const u32* a, const u32* b, u32* out) {
  u32 t[NW];
  u64 borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 d = (u64)a[i] - b[i] - borrow;
    t[i] = (u32)d;
    borrow = d >> 63;
  }
  if (borrow) {
    u64 carry = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      u64 s = (u64)t[i] + c.p[i] + carry;
      t[i] = (u32)s;
      carry = s >> 32;
    }
  }
  fe_copy(out, t);
}

HP_HD int fe_bit(const u32* e, int i) { return (e[i >> 5] >> (i & 31)) & 1; }

// out = a^(p-2) in Montgomery form (Fermat inversion; 0 -> 0), by a
// sliding window of up to 4 bits over the exponent: the odd powers a, a^3,
// ..., a^15 first (8 products), then a squaring a bit below the top
// window and a product a window. For the Pasta fields' p - 2 that is 289
// products in a chain (254 squarings, 27 window products, the table's 8),
// where a square-and-multiply over all 256 bits takes 333. The result is the
// field's unique inverse, the same words whatever the chain.
HP_HD void fe_inv(const Consts& c, const u32* a, u32* out) {
  u32 tbl[8][NW], a2[NW], acc[NW];
  fe_copy(tbl[0], a);
  mont_mul(c, a, a, a2);
  for (int k = 1; k < 8; ++k) mont_mul(c, tbl[k - 1], a2, tbl[k]);
  fe_copy(acc, c.one);
  bool started = false;  // acc is 1 until the top window: no squaring
  int i = NW * 32 - 1;
  while (i >= 0) {
    if (!fe_bit(c.pm2, i)) {
      if (started) mont_mul(c, acc, acc, acc);
      --i;
      continue;
    }
    int l = i - 3 < 0 ? 0 : i - 3;  // the window [l, i] ends in a set bit
    while (!fe_bit(c.pm2, l)) ++l;
    int w = 0;
    for (int k = i; k >= l; --k) {
      w = 2 * w + fe_bit(c.pm2, k);
      if (started) mont_mul(c, acc, acc, acc);
    }
    if (started)
      mont_mul(c, acc, tbl[w >> 1], acc);
    else
      fe_copy(acc, tbl[w >> 1]);
    started = true;
    i = l - 1;
  }
  fe_copy(out, acc);
}

}  // namespace hp
