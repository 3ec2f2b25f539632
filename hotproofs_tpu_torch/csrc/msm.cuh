// Per-thread bodies of the MSM kernels (msm.cu) and of the key-preparation
// kernel. They are __host__ __device__ so the CPU tests can run the exact
// per-thread code of each kernel over every (job, lane) and compare it with
// the plain torch versions (tests/test_torch_cuda_host.py).
//
// Layouts (all u32 words, row-major, n_lanes innermost where threads stream):
//   digits  (J, B, n_lanes)           int32 radix-16 digits in [0, 16)
//   bases   (B, 2, 8, n_lanes)        pre-scaled affine Montgomery x, y
//   buckets (J, 15, 3, 8, n_lanes)    per-lane projective buckets 1..15
//   reduced (J, 15, 3, 8)             one projective point per (job, slot)
//   out     (J, 3, 8)                 S = sum_v v * B_v per job
#pragma once

#include "curve.cuh"

namespace hp {

constexpr int NBUCKET = 15;        // digit values 1..15; digit 0 is skipped
constexpr int MERGE_THREADS = 256;  // threads per (job, slot) merge block

HP_HD void load_proj(const u32* base, size_t stride, Proj& r) {
  for (int k = 0; k < NW; ++k) {
    r.x[k] = base[(size_t)k * stride];
    r.y[k] = base[(size_t)(NW + k) * stride];
    r.z[k] = base[(size_t)(2 * NW + k) * stride];
  }
}

HP_HD void store_proj(u32* base, size_t stride, const Proj& r) {
  for (int k = 0; k < NW; ++k) {
    base[(size_t)k * stride] = r.x[k];
    base[(size_t)(NW + k) * stride] = r.y[k];
    base[(size_t)(2 * NW + k) * stride] = r.z[k];
  }
}

// K1 body: lane l of job j streams its B bases in order and mixed-adds each
// into the bucket its digit selects. Buckets start at the identity.
HP_HD void bucket_lane(const Consts& c, const int* digits, const u32* bases,
                       u32* buckets, int B, int n_lanes, int j, int l) {
  Proj bk[NBUCKET];
  for (int s = 0; s < NBUCKET; ++s) pt_identity(c, bk[s]);
  const size_t L = (size_t)n_lanes;
  for (int t = 0; t < B; ++t) {
    int d = digits[((size_t)j * B + t) * L + l];
    if (d <= 0 || d > NBUCKET) continue;
    Aff q;
    const u32* bt = bases + (size_t)t * 2 * NW * L + l;
    for (int k = 0; k < NW; ++k) {
      q.x[k] = bt[(size_t)k * L];
      q.y[k] = bt[(size_t)(NW + k) * L];
    }
    pt_add_mixed(c, bk[d - 1], q, bk[d - 1]);
  }
  for (int s = 0; s < NBUCKET; ++s)
    store_proj(buckets + ((size_t)j * NBUCKET + s) * 3 * NW * L + l, L,
               bk[s]);
}

// K2 body, first phase: thread tid of the (j, s) block sums lanes
// tid, tid + nthreads, ... of that slot (then the block tree-reduces).
HP_HD void merge_thread(const Consts& c, const u32* buckets, int n_lanes,
                        int j, int s, int tid, int nthreads, Proj& acc) {
  pt_identity(c, acc);
  const size_t L = (size_t)n_lanes;
  const u32* slot = buckets + ((size_t)j * NBUCKET + s) * 3 * NW * L;
  for (int l = tid; l < n_lanes; l += nthreads) {
    Proj q;
    load_proj(slot + l, L, q);
    pt_add(c, acc, q, acc);
  }
}

// K3 body: S = sum_{v=1..15} v * B_v by running suffix sums (30 adds).
HP_HD void wsum_job(const Consts& c, const u32* reduced, u32* out, int j) {
  Proj t, s;
  pt_identity(c, t);
  pt_identity(c, s);
  for (int v = NBUCKET; v >= 1; --v) {
    Proj bv;
    load_proj(reduced + ((size_t)j * NBUCKET + (v - 1)) * 3 * NW, 1, bv);
    pt_add(c, t, bv, t);
    pt_add(c, s, t, s);
  }
  store_proj(out + (size_t)j * 3 * NW, 1, s);
}

// K4 body: affine (x, y) = (X / Z, Y / Z) of one projective point, Fermat
// inversion in place (Z = 0 gives (0, 0)).
HP_HD void affine_point(const Consts& c, const u32* X, const u32* Y,
                        const u32* Z, u32* x, u32* y, size_t i) {
  u32 zinv[NW];
  fe_inv(c, Z + i * NW, zinv);
  mont_mul(c, X + i * NW, zinv, x + i * NW);
  mont_mul(c, Y + i * NW, zinv, y + i * NW);
}

}  // namespace hp
