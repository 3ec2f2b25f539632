// Hopper kernels of the field-multiply path: the batched Montgomery product
// behind the public field ops, and the staged and partial forms that time
// its pieces. Built by nvcc for sm_90a into the shared library of
// ops/cuda_lib.py, bound with ctypes. Each launcher runs on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// K5 mont_mul replaces _mont_mul_kernel / mont_mul_lm
//   (hotproofs_tpu/ops/pallas_field.py:267, 296), the reduction
//   _mont_reduce_rows (:176) that runs in its body, and the element-major
//   wrapper mont_mul_em (:320). One thread per element: it reads its two
//   operands in the public format (int32 digits, element- or limb-major,
//   or u32 words), packs them into 8 words in registers, runs the CIOS
//   product of field.cuh and writes the result in the same format, so one
//   public multiply, to_mont or from_mont is one launch with no repacking
//   pass around it. Bound by bytes, not by multiplies: in the digit format
//   a product moves 3 x 128 bytes for 264 32-bit multiplies. What the
//   design does about it: limb-major arrays are read digit row by digit row,
//   so a warp's 32 threads read 32 neighbouring ints (one 128-byte line) per
//   load; element-major arrays go through k_mont_mul_em, whose block moves
//   its 128 elements' contiguous 16 KB as 16-byte vectors, neighbouring
//   threads neighbouring vectors, packed four digits to a word through
//   shared memory on the way in and unpacked on the way out (a thread
//   reading its own 128-byte row ran at 43 % of the bound where limb-major
//   reached 79 %); a broadcast operand (R^2, 1, or a row repeated along the
//   leading axes) is indexed modulo its length and stays in cache, which
//   takes a third off the traffic.
// K10 mont_mul_stage replaces k1..k5 (tools/bench_pallas_bisect.py:45-73),
//   the five prefixes of the all-VPU mont_mul_rows (pallas_field.py:212-222).
//   One thread per element computes the product in its staged form on words
//   (T = a b; m = T mu mod R; U = T + m p; U / R; conditional subtract) and
//   stops after the stage asked for, writing the digits the TPU stage held
//   there. The stage is a template argument, so each prefix is its own
//   kernel without the later stages' code. Stage 5 against K5 sets the
//   staged form (320 word multiplies) beside CIOS (264) on this card.
// K11a mont_mul_part replaces k_conv, k_conv3 and k_norm
//   (tools/bench_pallas_parts.py:46-62): the digit convolution's low 32
//   columns, three chained convolutions, and one carry-normalise with the
//   conditional subtract, each on 8-bit digits in int32 registers as the
//   TPU computed them (528 byte products per convolution).
// Stages and parts read and write limb-major digits (32, n); they move the
// same 3 x 128 bytes an element and are bound by bytes as well.
#include <cuda_runtime.h>

#include "mont.cuh"

using namespace hp;

namespace {

constexpr int THREADS = 128;

unsigned blocks(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

__global__ void __launch_bounds__(THREADS)
    k_mont_mul(FieldConsts f, const int* __restrict__ a, long long na,
               const int* __restrict__ b, long long nb,
               int* __restrict__ out, long long n, int layout) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    mont_mul_elem(f, a, (size_t)na, b, (size_t)nb, out, (size_t)n, (size_t)i,
                  layout);
}

__global__ void __launch_bounds__(EM_TILE)
    k_mont_mul_em(FieldConsts f, const int* __restrict__ a, long long na,
                  const int* __restrict__ b, long long nb,
                  int* __restrict__ out, long long n) {
  __shared__ u32 sa[EM_TILE * EM_PITCH], sb[EM_TILE * EM_PITCH];
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * EM_TILE, i = base + tid;
  if (na == n) em_tile_load(a, (size_t)n, base, tid, sa);
  if (nb == n) em_tile_load(b, (size_t)n, base, tid, sb);
  __syncthreads();
  u32 x[NW];
  if (i < (size_t)n)
    em_tile_product(f, sa, sb, a, (size_t)na, b, (size_t)nb, (size_t)n, i,
                    tid, x);
  __syncthreads();                  // every read of sa is done
  if (i < (size_t)n) {
#pragma unroll
    for (int k = 0; k < NW; ++k) sa[tid * EM_PITCH + k] = x[k];
  }
  __syncthreads();
  em_tile_store(out, (size_t)n, base, tid, sa);
}

template <int STAGE>
__global__ void __launch_bounds__(THREADS)
    k_mont_mul_stage(FieldConsts f, const int* __restrict__ a,
                     const int* __restrict__ b, int* __restrict__ out,
                     long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) stage_elem(f, a, b, out, (size_t)n, (size_t)i, STAGE);
}

template <int PART>
__global__ void __launch_bounds__(THREADS)
    k_mont_mul_part(FieldConsts f, const int* __restrict__ a,
                    const int* __restrict__ b, int* __restrict__ out,
                    long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) part_elem(f, a, b, out, (size_t)n, (size_t)i, PART);
}

extern "C" {

int hp_mont_mul(const u32* consts, const int* a, long long na, const int* b,
                long long nb, int* out, long long n, int layout,
                void* stream) {
  if (layout == LAYOUT_EM)
    k_mont_mul_em<<<(unsigned)((n + EM_TILE - 1) / EM_TILE), EM_TILE, 0,
                    (cudaStream_t)stream>>>(load_field_consts(consts), a, na,
                                            b, nb, out, n);
  else
    k_mont_mul<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        load_field_consts(consts), a, na, b, nb, out, n, layout);
  return (int)cudaGetLastError();
}

#define HP_LAUNCH(kernel)                                            \
  kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(           \
      load_field_consts(consts), a, b, out, n)

int hp_mont_mul_stage(const u32* consts, const int* a, const int* b, int* out,
                      long long n, int stage, void* stream) {
  switch (stage) {
    case 1: HP_LAUNCH(k_mont_mul_stage<1>); break;
    case 2: HP_LAUNCH(k_mont_mul_stage<2>); break;
    case 3: HP_LAUNCH(k_mont_mul_stage<3>); break;
    case 4: HP_LAUNCH(k_mont_mul_stage<4>); break;
    case 5: HP_LAUNCH(k_mont_mul_stage<5>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int hp_mont_mul_part(const u32* consts, const int* a, const int* b, int* out,
                     long long n, int part, void* stream) {
  switch (part) {
    case PART_CONV: HP_LAUNCH(k_mont_mul_part<PART_CONV>); break;
    case PART_CONV3: HP_LAUNCH(k_mont_mul_part<PART_CONV3>); break;
    case PART_NORM: HP_LAUNCH(k_mont_mul_part<PART_NORM>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#undef HP_LAUNCH

}  // extern "C"
