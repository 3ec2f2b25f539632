// K11b conv_mma: the low 32 columns of the digit convolution through the
// tensor cores. Replaces conv_mxu / k_conv_mxu
// (tools/bench_pallas_parts.py:85, 74).
//
// The convolution col[c] = sum_{j+k=c} a_j b_k has no matrix shared between
// elements, so, as on the TPU, it becomes the product of a constant 0/1
// diagonal-sum matrix D (32 x 1024, D[c, 32 j + k] = [j + k == c]) with each
// element's outer product a_j b_k (1024 x n), split into high and low bytes
// because a byte product has 16 bits:
//     col = ((D . hi) << 8) + D . lo.
// The TPU multiplied in bf16; here the exact route is the integer one,
// mma.sync m16n8k32 with u8 operands and s32 accumulation.
//
// One warp takes 8 elements (the n of the tile). Depth step j of the 32
// covers the 32 products a_j b_0..31: in the B fragment a thread holds, for
// its element (lane / 4), the bytes of a_j b_k for k = 4 (lane % 4) + 0..3
// and 16 more, so it builds them in registers from a_j and its 8 digits of
// b. No outer product is ever stored, in shared memory or anywhere else. Its
// A fragment is the matching 16 x 32 block of D, which is a shifted
// identity: each register is one byte set or none, computed from the
// indices. Rows 0..15 need only j <= 15.
//
// Bound: each element moves 3 x 128 bytes; the 1,024 byte products and the
// two tensor-core passes over them stay under that at the card's rates, so
// the bound is bytes. The kernel itself is held up by building the products:
// an element's four threads make 1,024 integer multiplies and pack their
// bytes, where mont_mul needs 64 word products for the whole convolution.
// So it is kept as a measurement beside the `conv` part and the multiply
// does not use it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ND = 32;          // digits per element, columns computed
constexpr int WARPS = 4;        // warps per block
constexpr int TILE_N = 8;       // elements per warp (n of m16n8k32)

__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The register of D's fragment whose four bytes are columns k0..k0+3 of row
// c at depth step j: byte q is 1 where k0 + q == c - j.
__device__ __forceinline__ uint32_t diag4(int c, int j, int k0) {
  int d = c - j - k0;
  return (d >= 0 && d < 4) ? (1u << (8 * d)) : 0u;
}

}  // namespace

// a, b: (32, n) int32 digits, limb-major; out: (32, n) int32 lazy columns.
__global__ void __launch_bounds__(WARPS * 32)
    k_conv_mma(const int* __restrict__ a, const int* __restrict__ b,
               int* __restrict__ out, long long n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n0 = ((long long)blockIdx.x * WARPS + warp) * TILE_N;
  if (n0 >= n) return;                    // the whole warp leaves together
  const int g = lane >> 2, tig = lane & 3;
  const long long e = n0 + g;             // this thread's element
  const bool live = e < n;

  int ad[ND], bd[8];
#pragma unroll
  for (int j = 0; j < ND; ++j) ad[j] = live ? a[(long long)j * n + e] : 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bd[q] = live ? b[(long long)(4 * tig + q) * n + e] : 0;
    bd[4 + q] = live ? b[(long long)(16 + 4 * tig + q) * n + e] : 0;
  }

  int hi[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  int lo[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    uint32_t bl0 = 0, bh0 = 0, bl1 = 0, bh1 = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t p0 = (uint32_t)(ad[j] * bd[q]);
      uint32_t p1 = (uint32_t)(ad[j] * bd[4 + q]);
      bl0 |= (p0 & 0xFFu) << (8 * q);
      bh0 |= ((p0 >> 8) & 0xFFu) << (8 * q);
      bl1 |= (p1 & 0xFFu) << (8 * q);
      bh1 |= ((p1 >> 8) & 0xFFu) << (8 * q);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt == 0 && j > 15) continue;    // rows 0..15 have no such term
      const int c0 = 16 * mt + g, c1 = c0 + 8;
      const uint32_t a0 = diag4(c0, j, 4 * tig);
      const uint32_t a1 = diag4(c1, j, 4 * tig);
      const uint32_t a2 = diag4(c0, j, 16 + 4 * tig);
      const uint32_t a3 = diag4(c1, j, 16 + 4 * tig);
      mma_u8(lo[mt], a0, a1, a2, a3, bl0, bl1);
      mma_u8(hi[mt], a0, a1, a2, a3, bh0, bh1);
    }
  }

  // Accumulator layout: registers 0, 1 are row g, columns 2 tig + 0, 1 of the
  // tile; registers 2, 3 the same columns of row g + 8.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = 16 * mt + g + 8 * (r >> 1);
      const long long col = n0 + 2 * tig + (r & 1);
      if (col < n) out[(long long)c * n + col] = (hi[mt][r] << 8) + lo[mt][r];
    }
}

extern "C" int hp_conv_mma(const int* a, const int* b, int* out, long long n,
                           void* stream) {
  const long long tiles = (n + TILE_N - 1) / TILE_N;
  k_conv_mma<<<(unsigned)((tiles + WARPS - 1) / WARPS), WARPS * 32, 0,
               (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}
