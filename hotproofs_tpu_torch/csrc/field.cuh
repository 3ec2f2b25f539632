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
HP_HD void mont_mul(const Consts& c, const u32* a, const u32* b, u32* out) {
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

// out = a^(p-2) in Montgomery form (Fermat inversion; 0 -> 0).
HP_HD void fe_inv(const Consts& c, const u32* a, u32* out) {
  u32 acc[NW];
  fe_copy(acc, c.one);
  for (int w = NW - 1; w >= 0; --w) {
    for (int bit = 31; bit >= 0; --bit) {
      mont_mul(c, acc, acc, acc);
      if ((c.pm2[w] >> bit) & 1u) mont_mul(c, acc, a, acc);
    }
  }
  fe_copy(out, acc);
}

}  // namespace hp
