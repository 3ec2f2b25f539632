// Per-thread bodies of the bucket-design kernels (msm_designs.cu): the
// candidate alternatives to msm_bucket that the JAX package tried on the TPU
// as experiments. __host__ __device__, so the CPU tests run them through
// host_check.cc against the plain torch versions (ops/msm_pallas.py). The
// t-split and the signed digits run msm_bucket's body, bucket_walk
// (msm.cuh), over a step range and over signed digits.
//
// Layouts (u32 words; see msm.cuh for digits and bases):
//   chain   (J, 3, 8, n_lanes)            one accumulator per (job, lane)
//   tsplit  (J, 15, 3, 8, H * n_lanes)    set h of lane l at lane h*n_lanes+l
//   signed  (J, 8, 3, 8, n_lanes)         buckets for magnitudes 1..8
//   sdigits (J, B, n_lanes)               mag | (neg << 4), mag in 0..8
#pragma once

#include "msm.cuh"

namespace hp {

constexpr int NSIGNED = 8;  // signed-digit magnitudes 1..8; 0 is skipped

// msm_chain body: lane l of job j mixed-adds all B streamed bases, padding
// points included, into one accumulator that starts at the identity. No
// digit is read: a bucket kernel's add chain without its bucket select.
HP_HD void chain_lane(const Consts& c, const u32* bases, u32* out, int B,
                      int n_lanes, int j, int l) {
  Proj acc;
  pt_identity(c, acc);
  const size_t L = (size_t)n_lanes;
  for (int t = 0; t < B; ++t) {
    Aff q;
    load_base(bases, L, t, l, q);
    pt_add_mixed(c, acc, q, acc);
  }
  store_proj(out + (size_t)j * 3 * NW * L + l, L, acc);
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
