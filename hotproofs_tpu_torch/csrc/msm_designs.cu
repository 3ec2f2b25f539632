// Hopper kernels of the MSM bucket-design path (tools/msm_designs.py): the
// TPU experiments on the bucket kernel, ported so their answers can be read
// on this card. None is on the prover's path; each result goes through
// msm_merge and msm_wsum (msm.cu) unchanged. Built for sm_90a beside
// msm.cu and linked into the same library (ops/cuda_lib.py).
//
// msm_chain replaces pure_chain_call (tools/exp_bucket2.py:30) and pure_call
//   (tools/profile_msm_phases.py:139): the bucket kernel's add chain with no
//   bucket select, one thread per (job, lane) and one accumulator (96 B of
//   state instead of 1,440). Its time beside msm_bucket's at the same thread
//   count is what the buckets cost. Bound by integer multiply throughput
//   like msm_bucket (13 Montgomery products per mixed add, B adds a lane,
//   padding included), but every add is live. pure_call wrote the same sum
//   into slot 0 of 16; here the J jobs all compute the same lane sums, so
//   the ceiling can be read at msm_bucket's thread count at every shape.
// msm_bucket_tsplit replaces bucket_tsplit_call (tools/exp_tsplit.py:37).
//   Thread (j, h, l) accumulates steps [h B/H, (h+1) B/H) of lane l into its
//   own 15 buckets: H x the threads of msm_bucket, each with a chain H x
//   shorter, against H x the bucket state and merge work. msm_bucket fills
//   ~123 threads per SM at the comm_T shape (16,192 lanes on 132 SMs), so
//   more independent threads is the lever on this card. The TPU kernel put
//   set h at slot s * H + h, because its lane block was fixed and the slot
//   axis was free; here the lane axis is what the card parallelises, so set
//   h sits at lane h * n_lanes + l and msm_merge sums it like any lane.
// msm_bucket_signed replaces bucket_signed_call (tools/exp_signed_msm.py:65).
//   Signed radix-16 digits (magnitude 1..8, sign folded into y as p - y):
//   8 buckets (768 B of state) instead of 15 (1,440 B), and a 16-add
//   instead of a 30-add weighted sum; one more window where the scalars'
//   top nibble can exceed 7 (msm_pallas.signed_bits). The TPU's "2 halves
//   interleaved" variant is a VMEM scheduling device, not another function;
//   independent chains per SM are what the t-split gives here, so it has
//   no counterpart.
#include <cuda_runtime.h>

#include "msm_designs.cuh"

using namespace hp;

__global__ void k_msm_chain(Consts c, const u32* __restrict__ bases,
                            u32* __restrict__ out, int J, int B,
                            int n_lanes) {
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)J * n_lanes) return;
  chain_lane(c, bases, out, B, n_lanes, (int)(gid / n_lanes),
             (int)(gid % n_lanes));
}

__global__ void k_msm_bucket_tsplit(Consts c, const int* __restrict__ digits,
                                    const u32* __restrict__ bases,
                                    u32* __restrict__ buckets, int J, int B,
                                    int n_lanes, int H) {
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long hl = (long long)H * n_lanes;
  if (gid >= (long long)J * hl) return;
  const int j = (int)(gid / hl);
  const int ol = (int)(gid % hl);
  const int h = ol / n_lanes, l = ol % n_lanes;
  const int steps = B / H;
  bucket_range(c, digits, bases, buckets, B, n_lanes, j, l, h * steps,
               (h + 1) * steps, ol, H * n_lanes);
}

__global__ void k_msm_bucket_signed(Consts c, const int* __restrict__ digits,
                                    const u32* __restrict__ bases,
                                    u32* __restrict__ buckets, int J, int B,
                                    int n_lanes) {
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)J * n_lanes) return;
  signed_lane(c, digits, bases, buckets, B, n_lanes, (int)(gid / n_lanes),
              (int)(gid % n_lanes));
}

extern "C" {

int hp_msm_chain(const u32* consts, const u32* bases, u32* out, int J, int B,
                 int n_lanes, void* stream) {
  const int threads = 128;
  k_msm_chain<<<blocks_for((long long)J * n_lanes, threads), threads, 0,
                (cudaStream_t)stream>>>(load_consts(consts), bases, out, J,
                                        B, n_lanes);
  return (int)cudaGetLastError();
}

int hp_msm_bucket_tsplit(const u32* consts, const int* digits,
                         const u32* bases, u32* buckets, int J, int B,
                         int n_lanes, int H, void* stream) {
  const int threads = 128;
  k_msm_bucket_tsplit<<<blocks_for((long long)J * H * n_lanes, threads),
                        threads, 0, (cudaStream_t)stream>>>(
      load_consts(consts), digits, bases, buckets, J, B, n_lanes, H);
  return (int)cudaGetLastError();
}

int hp_msm_bucket_signed(const u32* consts, const int* digits,
                         const u32* bases, u32* buckets, int J, int B,
                         int n_lanes, void* stream) {
  const int threads = 128;
  k_msm_bucket_signed<<<blocks_for((long long)J * n_lanes, threads), threads,
                        0, (cudaStream_t)stream>>>(
      load_consts(consts), digits, bases, buckets, J, B, n_lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
