// Per-thread bodies of the field-multiply kernels (mont.cu): the batched
// Montgomery product in the public digit format, its five staged prefixes
// and its three parts. __host__ __device__, so the CPU tests run them
// through host_check.cc against the plain torch versions
// (ops/pallas_field.py).
//
// Formats (int32 tensors, n elements):
//   EM     (n, 32)  base-2^8 digits, element-major (the public format)
//   LM     (32, n)  base-2^8 digits, limb-major (digit k of element i at
//                   k * n + i: neighbouring threads read neighbouring ints)
//   WORDS  (n, 8)   little-endian u32 words
// Digits are canonical (0..255); a thread packs four of them into one word
// as it loads, so the product itself runs on 8 words in registers.
#pragma once

#include "field.cuh"

namespace hp {

constexpr int ND = 32;  // base-2^8 digits per field element

enum Layout { LAYOUT_EM = 0, LAYOUT_LM = 1, LAYOUT_WORDS = 2 };

struct Int4 {
  int x, y, z, w;
};

// Four consecutive ints, 16-byte aligned: one 16-byte access on the card.
HP_HD Int4 ld4(const int* p) {
#ifdef __CUDA_ARCH__
  int4 v = *reinterpret_cast<const int4*>(p);
  return Int4{v.x, v.y, v.z, v.w};
#else
  return Int4{p[0], p[1], p[2], p[3]};
#endif
}

HP_HD void st4(int* p, Int4 v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(p) = make_int4(v.x, v.y, v.z, v.w);
#else
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
#endif
}

HP_HD u32 pack4(int d0, int d1, int d2, int d3) {
  return (u32)d0 | ((u32)d1 << 8) | ((u32)d2 << 16) | ((u32)d3 << 24);
}

// Digit k (0..31) of 8 words.
HP_HD int digit_of(const u32* w, int k) {
  return (int)((w[k >> 2] >> (8 * (k & 3))) & 0xFFu);
}

// Element i of an array of n elements in `layout` -> 8 words.
HP_HD void load_elem(const int* a, size_t n, size_t i, int layout, u32* w) {
  if (layout == LAYOUT_EM) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      Int4 v = ld4(a + i * ND + 4 * k);
      w[k] = pack4(v.x, v.y, v.z, v.w);
    }
  } else if (layout == LAYOUT_LM) {
#pragma unroll
    for (int k = 0; k < NW; ++k)
      w[k] = pack4(a[(size_t)(4 * k) * n + i], a[(size_t)(4 * k + 1) * n + i],
                   a[(size_t)(4 * k + 2) * n + i],
                   a[(size_t)(4 * k + 3) * n + i]);
  } else {
    Int4 lo = ld4(a + i * NW), hi = ld4(a + i * NW + 4);
    w[0] = (u32)lo.x; w[1] = (u32)lo.y; w[2] = (u32)lo.z; w[3] = (u32)lo.w;
    w[4] = (u32)hi.x; w[5] = (u32)hi.y; w[6] = (u32)hi.z; w[7] = (u32)hi.w;
  }
}

// 8 words -> element i of an array of n elements, limb-major or words
// (element-major results leave through em_tile_store).
HP_HD void store_elem(int* out, size_t n, size_t i, int layout,
                      const u32* w) {
  if (layout == LAYOUT_LM) {
#pragma unroll
    for (int k = 0; k < ND; ++k) out[(size_t)k * n + i] = digit_of(w, k);
  } else {
    st4(out + i * NW, Int4{(int)w[0], (int)w[1], (int)w[2], (int)w[3]});
    st4(out + i * NW + 4, Int4{(int)w[4], (int)w[5], (int)w[6], (int)w[7]});
  }
}

// mont_mul body, limb-major or words: out[i] = a[i mod na] * b[i mod nb] *
// 2^-256 mod p, all three arrays in `layout`. An operand with fewer
// elements than n is broadcast (a constant, or one block repeated along the
// leading axes).
HP_HD void mont_mul_elem(const FieldConsts& f, const int* a, size_t na,
                         const int* b, size_t nb, int* out, size_t n,
                         size_t i, int layout) {
  u32 x[NW], y[NW];
  load_elem(a, na, na == n ? i : i % na, layout, x);
  load_elem(b, nb, nb == n ? i : i % nb, layout, y);
  mont_mul(f, x, y, x);
  store_elem(out, n, i, layout, x);
}

// The element-major kernel's tile: a block of EM_TILE threads takes EM_TILE
// consecutive elements, 16 KB of contiguous digits an operand. Its threads
// move that range as 16-byte vectors, neighbouring threads neighbouring
// vectors (vector v = r * EM_TILE + tid holds digits 4q..4q+3, q = v mod 8,
// of element v / 8 of the tile), and pack each into one word of a staging
// array in shared memory, EM_PITCH words an element (odd, so neither the
// staging nor a thread's read of its own element meets a bank conflict).
constexpr int EM_TILE = 128;
constexpr int EM_PITCH = NW + 1;

// Thread tid's share of staging in the tile at element `base` of a.
HP_HD void em_tile_load(const int* a, size_t n, size_t base, int tid,
                        u32* sh) {
#pragma unroll
  for (int r = 0; r < NW; ++r) {
    const int v = r * EM_TILE + tid, e = v / NW;
    if (base + e < n) {
      Int4 d = ld4(a + base * ND + (size_t)v * 4);
      sh[e * EM_PITCH + v % NW] = pack4(d.x, d.y, d.z, d.w);
    }
  }
}

// Thread tid's share of writing the staged tile out at element `base`.
HP_HD void em_tile_store(int* out, size_t n, size_t base, int tid,
                         const u32* sh) {
#pragma unroll
  for (int r = 0; r < NW; ++r) {
    const int v = r * EM_TILE + tid, e = v / NW;
    if (base + e < n) {
      const u32 w = sh[e * EM_PITCH + v % NW];
      st4(out + base * ND + (size_t)v * 4,
          Int4{(int)(w & 0xFFu), (int)((w >> 8) & 0xFFu),
               (int)((w >> 16) & 0xFFu), (int)(w >> 24)});
    }
  }
}

// Thread tid's product, element i = base + tid < n: each operand from its
// staged tile, or, where it is broadcast (fewer elements than n), straight
// from memory modulo its length.
HP_HD void em_tile_product(const FieldConsts& f, const u32* sa, const u32* sb,
                           const int* a, size_t na, const int* b, size_t nb,
                           size_t n, size_t i, int tid, u32* x) {
  u32 y[NW];
  if (na == n) {
#pragma unroll
    for (int k = 0; k < NW; ++k) x[k] = sa[tid * EM_PITCH + k];
  } else {
    load_elem(a, na, i % na, LAYOUT_EM, x);
  }
  if (nb == n) {
#pragma unroll
    for (int k = 0; k < NW; ++k) y[k] = sb[tid * EM_PITCH + k];
  } else {
    load_elem(b, nb, i % nb, LAYOUT_EM, y);
  }
  mont_mul(f, x, y, x);
}

// t[0..16) = a * b, the full 512-bit product.
HP_HD void mul_wide(const u32* a, const u32* b, u32* t) {
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)a[j] * b[i] + t[i + j] + carry;
      t[i + j] = (u32)s;
      carry = s >> 32;
    }
    t[i + NW] = (u32)carry;
  }
}

// out[0..8) = a * b mod 2^256.
HP_HD void mul_low(const u32* a, const u32* b, u32* out) {
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < NW - i; ++j) {
      u64 s = (u64)a[j] * b[i] + out[i + j] + carry;
      out[i + j] = (u32)s;
      carry = s >> 32;
    }
  }
}

// mont_mul_stage body, on LM digits: the product in its staged form
//   T = a * b;  m = T * mu mod R;  U = T + m * p;  U / R;  conditional - p
// cut after `stage` (1..5), each prefix written as the digit tensor the
// staged digit-serial product holds at that point:
//   1  the 32 canonical digits of T mod R
//   2  the 32 canonical digits of m
//   3  the low 32 lazy columns t_c + sum_{j<=c} m_j p_(c-j) of T + m * p
//      (int32 values of the digit representation, no carries)
//   4  the low 32 digits of U / R (before the conditional subtract)
//   5  the product a * b * 2^-256 mod p (equal to mont_mul's)
HP_HD void stage_elem(const FieldConsts& f, const int* a, const int* b,
                      int* out, size_t n, size_t i, int stage) {
  u32 x[NW], y[NW], t[2 * NW], m[NW];
  load_elem(a, n, i, LAYOUT_LM, x);
  load_elem(b, n, i, LAYOUT_LM, y);
  mul_wide(x, y, t);
  if (stage == 1) {
    store_elem(out, n, i, LAYOUT_LM, t);
    return;
  }
  mul_low(t, f.mu, m);
  if (stage == 2) {
    store_elem(out, n, i, LAYOUT_LM, m);
    return;
  }
  if (stage == 3) {
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      int acc = digit_of(t, c);
#pragma unroll
      for (int j = 0; j <= c; ++j)
        acc += digit_of(m, j) * digit_of(f.p, c - j);
      out[(size_t)c * n + i] = acc;
    }
    return;
  }
  // U = T + m * p is divisible by R; res = U / R < 2p is 8 words and a bit.
  u32 mp[2 * NW], res[NW];
  mul_wide(m, f.p, mp);
  u64 carry = 0;
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) {
    u64 s = (u64)t[k] + mp[k] + carry;
    if (k >= NW) res[k - NW] = (u32)s;
    carry = s >> 32;
  }
  if (stage == 5 && (carry || geq_p(res, f.p))) sub_p(res, f.p);
  store_elem(out, n, i, LAYOUT_LM, res);
}

enum Part { PART_CONV = 0, PART_CONV3 = 1, PART_NORM = 2 };

// Low 32 lazy columns of the digit convolution x * y: col[c] = sum_{j<=c}
// x[j] * y[c - j] (528 byte products).
HP_HD void conv_low(const int* x, const int* y, int* col) {
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    int acc = 0;
#pragma unroll
    for (int j = 0; j <= c; ++j) acc += x[j] * y[c - j];
    col[c] = acc;
  }
}

// mont_mul_part body, on LM digits, int32 out (32, n):
//   PART_CONV   the low 32 convolution columns of a * b, & 0xFF
//   PART_CONV3  three chained convolutions, masked and never carried:
//               t = a * b; m = (t & 0xFF) * mu; out = t + (m & 0xFF) * p
//               (low 32 columns of each)
//   PART_NORM   one normalisation: the exact carry of the columns
//               255 a_k + b_k (33 digits), then the conditional subtract of
//               p over those 33 digits; the low 32 digits
HP_HD void part_elem(const FieldConsts& f, const int* a, const int* b,
                     int* out, size_t n, size_t i, int part) {
  int x[ND], y[ND], r[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    x[k] = a[(size_t)k * n + i];
    y[k] = b[(size_t)k * n + i];
  }
  if (part == PART_CONV) {
    conv_low(x, y, r);
#pragma unroll
    for (int k = 0; k < ND; ++k) r[k] &= 0xFF;
  } else if (part == PART_CONV3) {
    int t[ND], m[ND], c[ND];
    conv_low(x, y, t);
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      x[k] = t[k] & 0xFF;
      c[k] = digit_of(f.mu, k);
    }
    conv_low(x, c, m);
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      x[k] = m[k] & 0xFF;
      c[k] = digit_of(f.p, k);
    }
    conv_low(x, c, r);
#pragma unroll
    for (int k = 0; k < ND; ++k) r[k] += t[k];
  } else {
    int carry = 0;
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      int v = x[k] * 255 + y[k] + carry;
      x[k] = v & 0xFF;
      carry = v >> 8;
    }
    // x[0..32) and `carry` are the 33 digits; p's 33rd digit is 0.
    int borrow = 0;
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      int d = x[k] - digit_of(f.p, k) - borrow;
      borrow = d < 0;
      r[k] = d & 0xFF;
    }
    if (carry - borrow < 0) {          // value < p: keep it
#pragma unroll
      for (int k = 0; k < ND; ++k) r[k] = x[k];
    }
  }
#pragma unroll
  for (int k = 0; k < ND; ++k) out[(size_t)k * n + i] = r[k];
}

}  // namespace hp
