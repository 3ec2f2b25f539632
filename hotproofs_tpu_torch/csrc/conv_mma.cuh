// Per-thread code of the tensor-core convolution (conv_mma.cu): the
// staging of a tile of elements through shared memory, the register
// fragments of mma.sync.m16n8k32 (u8 operands, s32 accumulators) and the
// map from accumulators to output columns. It is __host__ __device__ so
// the CPU tests run it (csrc/host_check.cc, tests/test_torch_cuda_host.py)
// under a host model of the instruction's fragment layout.
//
// The function: for each element e of two limb-major (32, n) digit arrays,
// col[c] = sum_{j + k = c} a_j b_k for c < 32 (the low 32 lazy columns of
// the digit product, no mask, no carry). Per element this is col = T_b a,
// with T_b the 32 x 32 lower-triangular Toeplitz matrix of b's bytes,
// T_b[c][j] = b_{c - j} (0 for j > c). T_b is the A operand of two mma
// instructions (m-tiles: rows 0-15 and 16-31), a's bytes the B operand,
// every column of B the same, so every column of D holds the same 16
// sums. A column is at most 32 x 255^2 = 2,080,800 < 2^31: one byte plane
// and the s32 accumulator are exact.
//
// Fragment layout (PTX ISA, mma.m16n8k32 .u8; g = lane / 4, t = lane % 4):
//   A (16 x 32, row-major): a0 row g, cols 4t..4t+3; a1 row g + 8, same
//     cols; a2, a3 the same rows, cols 16 + 4t..; byte i = col 4t + i.
//   B (32 x 8, col-major): b0 rows 4t..4t+3, b1 rows 16 + 4t.., col g.
//   C/D (16 x 8, s32): d0, d1 row g, cols 2t, 2t + 1; d2, d3 row g + 8.
// An A register is four consecutive columns k0..k0+3 of row c of T_b:
// b_{c-k0}, b_{c-k0-1}, b_{c-k0-2}, b_{c-k0-3}, a window of b's bytes
// read backwards. So b's digits are packed reversed, 4 to a word, and
// zero-padded above (rev: word q holds b_{31-4q} .. b_{28-4q}; words 8 and
// up read as 0); the window starting at byte o = 31 - (c - k0) is one byte
// permute of words o / 4 and o / 4 + 1. No multiply builds an operand.
#pragma once

#include "field.cuh"

namespace hp {

constexpr int CONV_DIGITS = 32;
constexpr int CONV_WORDS = 8;                 // packed words of 32 digits
constexpr int CONV_TILE = 128;                // elements (and threads) a block
constexpr int CONV_WARPS = CONV_TILE / 32;
constexpr int CONV_PITCH = CONV_TILE + 1;     // shared rows: a word apart
                                              // per row, no bank conflict

// __byte_perm: byte i of the result is byte ((s >> 4i) & 7) of y:x (x the
// low four bytes).
HP_HD u32 byte_perm(u32 x, u32 y, u32 s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  u32 r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (u32)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
#endif
}

// The low bytes of four digits, d0 in byte 0.
HP_HD u32 pack4(u32 d0, u32 d1, u32 d2, u32 d3) {
  return byte_perm(byte_perm(d0, d1, 0x0040), byte_perm(d2, d3, 0x0040),
                   0x5410);
}

// Staging in: thread t packs element e0 + t of a and b ((32, n), limb-major:
// every load of a warp is one row's consecutive digits) into the tile's
// word-major shared rows, pa[q * pitch + t] = a_{4q} .. a_{4q+3} and
// rev[q * pitch + t] = b_{31-4q} .. b_{28-4q}; an element past n is zero.
HP_HD void conv_stage_in(const int* a, const int* b, long long n,
                         long long e0, int t, u32* pa, u32* rev, int pitch) {
  const long long e = e0 + t;
  const bool live = e < n;
#pragma unroll
  for (int q = 0; q < CONV_WORDS; ++q) {
    u32 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = live ? (u32)a[(long long)(4 * q + i) * n + e] : 0u;
      y[i] = live ? (u32)b[(long long)(31 - 4 * q - i) * n + e] : 0u;
    }
    pa[q * pitch + t] = pack4(x[0], x[1], x[2], x[3]);
    rev[q * pitch + t] = pack4(y[0], y[1], y[2], y[3]);
  }
}

// Columns k0..k0 + 3 of row c of T_b (k0 a multiple of 4).
HP_HD u32 toeplitz_word(const u32* rev, int pitch, int c, int k0) {
  const int o = 31 - (c - k0);                // 0 .. 59
  const int q = o >> 2;
  const u32 lo = q < CONV_WORDS ? rev[q * pitch] : 0u;
  const u32 hi = q + 1 < CONV_WORDS ? rev[(q + 1) * pitch] : 0u;
  return byte_perm(lo, hi, 0x3210u + 0x1111u * (u32)(o & 3));
}

// One element's fragments for lane: A of both m-tiles (af[mt][0..3]; tile
// 1's a2, a3 are tile 0's a0, a1) and B (a's words t and 4 + t). pa and
// rev point at the element's column of the tile.
HP_HD void conv_frags(const u32* pa, const u32* rev, int pitch, int lane,
                      u32 (&af)[2][4], u32 (&bf)[2]) {
  const int g = lane >> 2, k0 = 4 * (lane & 3);
  af[0][0] = toeplitz_word(rev, pitch, g, k0);
  af[0][1] = toeplitz_word(rev, pitch, g + 8, k0);
  af[0][2] = toeplitz_word(rev, pitch, g, k0 + 16);
  af[0][3] = toeplitz_word(rev, pitch, g + 8, k0 + 16);
  af[1][0] = toeplitz_word(rev, pitch, g + 16, k0);
  af[1][1] = toeplitz_word(rev, pitch, g + 24, k0);
  af[1][2] = af[0][0];
  af[1][3] = af[0][1];
  bf[0] = pa[(lane & 3) * pitch];
  bf[1] = pa[(4 + (lane & 3)) * pitch];
}

// The column lane stores, and its value among the two tiles' accumulators:
// lane (g, t) holds rows g and g + 8 of both tiles (every column of D is
// the same), and takes tile t / 2, row g + 8 (t % 2): column g + 8t.
HP_HD int conv_out_col(int lane) { return (lane >> 2) + 8 * (lane & 3); }

HP_HD int conv_pick(const int (&d)[2][4], int lane) {
  const int v0 = (lane & 1) ? d[0][2] : d[0][0];
  const int v1 = (lane & 1) ? d[1][2] : d[1][0];
  return (lane & 2) ? v1 : v0;
}

// Staging out: thread t stores element e0 + t's 32 columns from the tile's
// shared rows (one row's consecutive elements a warp: coalesced).
HP_HD void conv_stage_out(const int* so, int* out, long long n, long long e0,
                          int t, int pitch) {
  const long long e = e0 + t;
  if (e >= n) return;
#pragma unroll
  for (int c = 0; c < CONV_DIGITS; ++c)
    out[(long long)c * n + e] = so[c * pitch + t];
}

}  // namespace hp
