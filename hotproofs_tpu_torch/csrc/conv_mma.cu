// K11b conv_mma: the low 32 columns of the digit convolution through the
// tensor cores. Replaces conv_mxu / k_conv_mxu
// (tools/bench_pallas_parts.py:85, 74).
//
// The TPU kernel summed each element's outer product a_j b_k (1,024 rows,
// split into high and low bytes) with a constant 0/1 diagonal matrix on
// the MXU. Here there is no outer product: per element, col = T_b a with
// T_b the Toeplitz matrix of b's bytes as mma.sync's A operand and a's
// bytes as its B operand (conv_mma.cuh has the formulation and the
// fragment layout). The s32 accumulator holds a column exactly, so one
// pass over one byte plane gives the lazy columns.
//
// Bound: bytes. Each element moves 3 x 128 bytes (a, b in, the columns
// out); its two m16n8k32 products (16,384 operations, 1/8 of them used)
// take 1/8 of the memory time at the card's int8 rate. So the kernel
// stages a tile of CONV_TILE elements through shared memory with coalesced
// rows (every digit read once, every column written once), builds the
// operands with byte permutes of b's reversed words (no multiply on the
// CUDA cores) and runs the mma per element, each warp a quarter of the
// tile.
#include <cuda_runtime.h>

#include "conv_mma.cuh"

using namespace hp;

namespace {

__device__ __forceinline__ void mma_u8(int (&d)[4], const u32 (&a)[4],
                                       const u32 (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace

// a, b: (32, n) int32 digits, limb-major; out: (32, n) int32 lazy columns.
__global__ void __launch_bounds__(CONV_TILE)
    k_conv_mma(const int* __restrict__ a, const int* __restrict__ b,
               int* __restrict__ out, long long n) {
  __shared__ u32 pa[CONV_WORDS * CONV_PITCH], rev[CONV_WORDS * CONV_PITCH];
  __shared__ int so[CONV_DIGITS * CONV_PITCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long e0 = (long long)blockIdx.x * CONV_TILE;
  conv_stage_in(a, b, n, e0, tid, pa, rev, CONV_PITCH);
  __syncthreads();
#pragma unroll 4
  for (int te = warp; te < CONV_TILE; te += CONV_WARPS) {
    u32 af[2][4], bf[2];
    conv_frags(pa + te, rev + te, CONV_PITCH, lane, af, bf);
    int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    mma_u8(d[0], af[0], bf);
    mma_u8(d[1], af[1], bf);
    so[conv_out_col(lane) * CONV_PITCH + te] = conv_pick(d, lane);
  }
  __syncthreads();
  conv_stage_out(so, out, n, e0, tid, CONV_PITCH);
}

extern "C" int hp_conv_mma(const int* a, const int* b, int* out, long long n,
                           void* stream) {
  k_conv_mma<<<(unsigned)((n + CONV_TILE - 1) / CONV_TILE), CONV_TILE, 0,
               (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}
