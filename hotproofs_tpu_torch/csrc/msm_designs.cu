// Hopper kernels of the MSM bucket-design path (tools/msm_designs.py): the
// TPU experiments on the bucket kernel, ported so their answers can be read
// on this card. None is on the prover's path; each result goes through
// msm_merge and msm_wsum (msm.cu) unchanged. Built for sm_90a beside
// msm.cu and linked into the same library (ops/cuda_lib.py).
//
// msm_chain replaces pure_chain_call (tools/exp_bucket2.py:30) and pure_call
//   (tools/profile_msm_phases.py:139): the bucket kernel's add chain with no
//   bucket select and one accumulator (96 B of state instead of 1,440).
//   Its time beside msm_bucket's at the same thread count is what the
//   buckets cost. Bound by integer multiply throughput like msm_bucket (11
//   Montgomery products per mixed add, B adds a lane, padding included),
//   but every add is live. pure_call wrote the same sum into slot 0 of 16;
//   here the J jobs all compute the same lane sums, so the ceiling can be
//   read at msm_bucket's thread count at every shape. Redesigned for the
//   card: one thread a (job, lane) left comm_T J=1 at 16,192 threads, four
//   warps an SM, each waiting on its chain of dependent adds; now each lane
//   is H sub-chains of B/H adds on H adjacent threads, joined by log2 H
//   levels of warp shuffles and complete adds (msm_designs.cuh:
//   chain_part, chain_join); H = 1 is msm_bucket's thread map. The adds
//   run on the lean field backend (field_lean.cuh: PTX carry chains,
//   branch-free reductions, 3b by additions).
// msm_bucket_tsplit replaces bucket_tsplit_call (tools/exp_tsplit.py:37).
//   Thread (j, h, l) accumulates steps [h B/H, (h+1) B/H) of lane l into its
//   own 15 buckets: H x the threads of msm_bucket, each with a chain H x
//   shorter, against H x the bucket state and merge work. msm_bucket fills
//   ~123 threads per SM at the comm_T shape (16,192 lanes on 132 SMs), so
//   more independent threads is the lever on this card, and at the W
//   shapes, where window 0's lanes chain up to ~50 adds and the others a
//   few, the split cuts the long chains that a warp waits on. The TPU
//   kernel put set h at slot s * H + h, because its lane block was fixed
//   and the slot axis was free; here the lane axis is what the card
//   parallelises, so set h sits at lane h * n_lanes + l and msm_merge sums
//   it like any lane.
// msm_bucket_signed replaces bucket_signed_call (tools/exp_signed_msm.py:65).
//   Signed radix-16 digits (magnitude 1..8, sign folded into y as p - y):
//   8 buckets (768 B of state) instead of 15 (1,440 B), and a 6-add
//   instead of an 8-add critical path in msm_wsum; one more window where
//   the scalars' top nibble can exceed 7 (msm_pallas.signed_bits). The
//   TPU's "2 halves interleaved" variant is a VMEM scheduling device, not
//   another function; independent chains per SM are what the t-split gives
//   here, so it has no counterpart.
// Both run msm_bucket's body (msm.cuh: bucket_walk), not a loop of their
//   own: a counting sort of each thread's digits in shared memory, one
//   register accumulator walking the nonzero steps grouped by digit, bases
//   read from the key's lane-major copy, finished buckets stored in one
//   coalesced pass. Bound, like msm_bucket, by the latency of each
//   thread's dependent mixed adds (one per nonzero digit), a warp lasting
//   as long as its busiest thread: a loop that steps every lane through
//   all B steps together, as the TPU designs did, runs an add at every
//   step where any lane of the warp has a nonzero digit, and a bucket
//   array indexed by the digit lives in local memory.
#include <cuda_runtime.h>

#include "msm_designs.cuh"

using namespace hp;

// Thread gid = (j n_lanes + l) H + h is sub-chain h of lane l of job j:
// a lane's H threads are adjacent in one warp (H divides 32), so its
// halving tree (chain_join) runs as log2 H levels of shuffles, each lane
// of the warp taking part (threads past the end chain nothing and hold
// the identity). Lean field backend (field_lean.cuh).
__global__ void __launch_bounds__(CHAIN_THREADS)
    k_msm_chain(LeanConsts c, const u32* __restrict__ bases,
                u32* __restrict__ out, int J, int B, int n_lanes, int H) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lane = gid / H;
  const int h = (int)(gid % H);
  const bool live = lane < (long long)J * n_lanes;
  const int l = (int)(lane % n_lanes);
  Proj acc;
  if (live)
    chain_part(c, bases, B, n_lanes, H, l, h, acc);
  else
    pt_identity(c, acc);
#pragma unroll 1
  for (int off = H / 2; off > 0; off >>= 1) {
    Proj o;
    shfl_down_proj(acc, off, o);
    if (h < off) acc_add(c, acc, o);
  }
  const size_t L = (size_t)n_lanes;
  if (live && h == 0)
    store_proj(out + (size_t)(lane / n_lanes) * 3 * NW * L + l, L, acc);
}

// Block (x, j): launch indices ol = x * BUCKET_LANES + t of job j, each
// split_walk's thread (msm_designs.cuh); the byte tiles are bucket_walk's.
// Capped at 128 registers, four blocks an SM (msm_bucket's 168 allow
// three): the t-split has H x the threads, and at comm_T J=1 H = 4's
// 64,768 fit one wave only at four. Measured on an H100 against the
// uncapped build at the four shapes of tools/msm_designs.py, the cap
// spills 184 B and is 7-22 % faster at comm_T J=1 H = 4, W J=256 and
// comm_T J=16, 2-3 % slower at comm_T J=1 H = 2 and at W J=16; the signed
// body fits 128 registers either way.
template <int S, bool SIGNED>
__global__ void __launch_bounds__(BUCKET_LANES, 4)
    k_split_walk(Consts c, const int* __restrict__ digits,
                 const u32* __restrict__ bases_lm, u32* __restrict__ buckets,
                 int B, int n_lanes, int H) {
  __shared__ unsigned char dig[BUCKET_MAX_STEPS * BUCKET_LANES];
  __shared__ unsigned char list[BUCKET_MAX_STEPS * BUCKET_LANES];
  __shared__ unsigned char cnt[(NBUCKET + 1) * BUCKET_LANES];
  const int t = threadIdx.x;
  const int ol = blockIdx.x * BUCKET_LANES + t;
  if (ol >= H * n_lanes) return;
  split_walk<S, SIGNED>(c, digits, bases_lm, buckets, B, n_lanes, H,
                        blockIdx.y, ol, dig + t, list + t, cnt + t,
                        BUCKET_LANES);
}

template <int S, bool SIGNED>
static int launch_split_walk(const u32* consts, const int* digits,
                             const u32* bases_lm, u32* buckets, int J, int B,
                             int n_lanes, int H, void* stream) {
  if (B > BUCKET_MAX_STEPS || J > 65535 || H < 1 || B % H)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)H * n_lanes, BUCKET_LANES), J);
  k_split_walk<S, SIGNED><<<grid, BUCKET_LANES, 0, (cudaStream_t)stream>>>(
      load_consts(consts), digits, bases_lm, buckets, B, n_lanes, H);
  return (int)cudaGetLastError();
}

extern "C" {

// lean_consts: the 34 words of load_lean_consts; H a power of two that
// divides 32 and B.
int hp_msm_chain(const u32* lean_consts, const u32* bases, u32* out, int J,
                 int B, int n_lanes, int H, void* stream) {
  if (H < 1 || H > 32 || (H & (H - 1)) || B % H)
    return (int)cudaErrorInvalidValue;
  k_msm_chain<<<blocks_for((long long)J * n_lanes * H, CHAIN_THREADS),
                CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
      load_lean_consts(lean_consts), bases, out, J, B, n_lanes, H);
  return (int)cudaGetLastError();
}

// bases_lm: the lane-major (n_lanes, B, 2, 8) bases, 16-byte aligned; H
// divides B <= BUCKET_MAX_STEPS.
int hp_msm_bucket_tsplit(const u32* consts, const int* digits,
                         const u32* bases_lm, u32* buckets, int J, int B,
                         int n_lanes, int H, void* stream) {
  return launch_split_walk<NBUCKET, false>(consts, digits, bases_lm, buckets,
                                           J, B, n_lanes, H, stream);
}

int hp_msm_bucket_signed(const u32* consts, const int* digits,
                         const u32* bases_lm, u32* buckets, int J, int B,
                         int n_lanes, void* stream) {
  return launch_split_walk<NSIGNED, true>(consts, digits, bases_lm, buckets,
                                          J, B, n_lanes, 1, stream);
}

}  // extern "C"
