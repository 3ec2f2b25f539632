// Hopper kernel of the batched Poseidon permutation. Built by nvcc for
// sm_90a into the shared library of ops/cuda_lib.py, bound with ctypes; the
// launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
// poseidon_permute replaces permute (hotproofs_tpu/ops/poseidon.py:247), a
// branchless lax.scan over the rounds on (..., t, 32) Montgomery digits
// with its constants from _device_constants (:224). One thread a state:
// it packs its t x 32 digits into t x 8 words in registers, runs every
// round there (poseidon.cuh) and unpacks the result, so a permutation is
// one launch with no pass around it. Bound by multiplies, not bytes: at
// t = 3 with (8, 57) rounds a state moves 768 bytes for 209,520 32-bit
// multiplies (a product 264, a squaring 208). What the design does about
// it: the products run on the lean field backend's PTX carry chains
// (field_lean.cuh), x^2 and x^4 on its squaring, a partial round raises
// lane 0 alone, and the constants are read at one address a warp (a
// broadcast from L1). A sparse partial-round MDS, or several threads a
// state, would do less or spread the work; neither is built.
// t is a template argument (the state's arrays stay in registers): 3, the
// transcript's shape, and 5 and 9, neptune's arities 4 and 8.
#include <cuda_runtime.h>

#include "poseidon.cuh"

using namespace hp;

namespace {

constexpr int THREADS = 128;

template <int T>
__global__ void __launch_bounds__(THREADS)
    k_poseidon(LeanConsts c, const u32* __restrict__ rc_mds, int r_full,
               int r_partial, const int* __restrict__ in,
               int* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    poseidon_elem<T>(c, rc_mds, r_full, r_partial, in, out, (size_t)i);
}

template <int T>
void launch(const LeanConsts& c, const u32* rc_mds, int r_full,
            int r_partial, const int* in, int* out, long long n,
            cudaStream_t stream) {
  k_poseidon<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                  stream>>>(c, rc_mds, r_full, r_partial, in, out, n);
}

}  // namespace

extern "C" {

// in, out: (n, t, 32) int32 Montgomery digits; rc_mds: the round constants
// (r_full + r_partial, t, 8) then the MDS matrix (t, t, 8), Montgomery
// words, on the card; consts: the FieldConsts pack, on the host.
int hp_poseidon_permute(const u32* consts, const u32* rc_mds, int t,
                        int r_full, int r_partial, const int* in, int* out,
                        long long n, void* stream) {
  const LeanConsts c = lean_field_consts(load_field_consts(consts));
  cudaStream_t s = (cudaStream_t)stream;
  switch (t) {
    case 3: launch<3>(c, rc_mds, r_full, r_partial, in, out, n, s); break;
    case 5: launch<5>(c, rc_mds, r_full, r_partial, in, out, n, s); break;
    case 9: launch<9>(c, rc_mds, r_full, r_partial, in, out, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
