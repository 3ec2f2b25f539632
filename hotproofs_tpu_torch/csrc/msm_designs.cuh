// Per-thread bodies of the bucket-design kernels (msm_designs.cu): the
// candidate alternatives to msm_bucket that the JAX package tried on the TPU
// as experiments. __host__ __device__, so the CPU tests run them through
// host_check.cc against the plain torch versions (ops/msm_pallas.py). The
// t-split and the signed digits run msm_bucket's body, bucket_walk
// (msm.cuh), over a step range and over signed digits.
//
// Layouts (u32 words; see msm.cuh for digits and bases):
//   chain   (J, 3, 8, n_lanes)            one sum per (job, lane)
//   tsplit  (J, 15, 3, 8, H * n_lanes)    set h of lane l at lane h*n_lanes+l
//   signed  (J, 8, 3, 8, n_lanes)         buckets for magnitudes 1..8
//   sdigits (J, B, n_lanes)               mag | (neg << 4), mag in 0..8
#pragma once

#include "field_lean.cuh"
#include "msm.cuh"

namespace hp {

constexpr int NSIGNED = 8;  // signed-digit magnitudes 1..8; 0 is skipped
constexpr int CHAIN_THREADS = 128;  // threads per msm_chain block

// msm_chain body: sub-chain h of H of lane l mixed-adds the streamed
// bases [h B/H, (h+1) B/H) of that lane, padding points included, into
// acc from the identity. No digit is read: a bucket kernel's add chain
// without its bucket select. The kernel gives a lane's H sub-chains to H
// adjacent threads of a warp and joins them by chain_join's halving tree
// (H = 1: one thread chains all B, as msm_bucket's thread does).
HP_HD void chain_part(const LeanConsts& c, const u32* bases, int B,
                      int n_lanes, int H, int l, int h, Proj& acc) {
  pt_identity(c, acc);
  const size_t L = (size_t)n_lanes;
  const int steps = B / H;
#pragma unroll 1
  for (int t = h * steps; t < (h + 1) * steps; ++t) {
    Aff q;
    load_base(bases, L, t, l, q);
    pt_add_mixed(c, acc, q, acc);
  }
}

// The join of a lane's H sub-chain sums part[0..H), H a power of two:
// levels off = H/2, H/4, ..., 1, sub-chain h < off taking h + off
// (acc_add); the lane's sum is left in part[0]. The kernel runs the same
// levels as warp shuffles; this is its host replay.
HP_HD void chain_join(const LeanConsts& c, Proj* part, int H) {
  for (int off = H / 2; off > 0; off >>= 1)
    for (int h = 0; h < off; ++h) acc_add(c, part[h], part[h + off]);
}

// The design kernels' thread map: launch index ol of H * n_lanes (one
// job) is set h = ol / n_lanes of lane l = ol % n_lanes, over steps
// [h B/H, (h+1) B/H) of that lane, stored at output lane ol; the signed
// kernel is H = 1 over S = NSIGNED signed digits. host_check.cc replays
// it for every launch index.
template <int S, bool SIGNED>
HP_HD void split_walk(const Consts& c, const int* digits, const u32* bases_lm,
                      u32* buckets, int B, int n_lanes, int H, int j, int ol,
                      unsigned char* dig, unsigned char* list,
                      unsigned char* cnt, int stride) {
  const int h = ol / n_lanes, l = ol % n_lanes, steps = B / H;
  bucket_walk<S, SIGNED>(c, digits, bases_lm, buckets, B, n_lanes, j, l,
                         h * steps, steps, ol, H * n_lanes, dig, list, cnt,
                         stride);
}

}  // namespace hp
