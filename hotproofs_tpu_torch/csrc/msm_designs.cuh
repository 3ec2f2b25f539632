// Per-thread bodies of the bucket-design kernels (msm_designs.cu): the
// candidate alternatives to msm_bucket that the JAX package tried on the TPU
// as experiments. __host__ __device__, so the CPU tests run them through
// host_check.cc against the plain torch versions (ops/msm_pallas.py).
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
// digit is read: the add chain of bucket_range without its bucket select.
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

// msm_bucket_signed body: lane l of job j streams its B bases; a digit
// with magnitude 1..8 mixed-adds the base, with y replaced by p - y when
// its sign bit is set, into bucket mag - 1.
HP_HD void signed_lane(const Consts& c, const int* digits, const u32* bases,
                       u32* buckets, int B, int n_lanes, int j, int l) {
  Proj bk[NSIGNED];
  for (int s = 0; s < NSIGNED; ++s) pt_identity(c, bk[s]);
  const size_t L = (size_t)n_lanes;
  u32 zero[NW];
  fe_zero(zero);
  for (int t = 0; t < B; ++t) {
    int e = digits[((size_t)j * B + t) * L + l];
    int mag = e & 15;
    if (mag == 0 || mag > NSIGNED) continue;
    Aff q;
    load_base(bases, L, t, l, q);
    if ((e >> 4) & 1) fe_sub(c, zero, q.y, q.y);
    pt_add_mixed(c, bk[mag - 1], q, bk[mag - 1]);
  }
  for (int s = 0; s < NSIGNED; ++s)
    store_proj(buckets + ((size_t)j * NSIGNED + s) * 3 * NW * L + l, L,
               bk[s]);
}

}  // namespace hp
