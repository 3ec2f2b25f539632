// Per-thread bodies of the MSM kernels (msm.cu) and of the key-preparation
// kernel. They are __host__ __device__ so the CPU tests can run the exact
// per-thread code of each kernel over every (job, lane) and compare it with
// the plain torch versions (tests/test_torch_cuda_host.py).
//
// Layouts (all u32 words, row-major, n_lanes innermost where threads stream):
//   digits  (J, B, n_lanes)           int32 radix-16 digits in [0, 16)
//   bases   (B, 2, 8, n_lanes)        pre-scaled affine Montgomery x, y
//   bases_lm (n_lanes, B, 2, 8)       the same, lane-major (msm_bucket)
//   buckets (J, S, 3, 8, n_lanes)     per-lane projective buckets 1..S
//   reduced (J, S, 3, 8)              one projective point per (job, slot)
//   out     (J, 3, 8)                 sum_v v * B_v per job
//   X, Y, Z, x, y (N, 8)              to_affine's points, one per row
// S is 15 for msm_bucket's radix-16 buckets (and the t-split's, whose H
// sets sit on the lane axis) and 8 for the signed-digit buckets
// (msm_designs.cuh); merge takes any S, wsum any S up to
// WSUM_MAX_SLOTS.
//
// The constants below have twins of the same names in
// hotproofs_tpu_torch/ops/msm_pallas.py (a CPU test holds them equal).
#pragma once

#include "curve.cuh"

namespace hp {

constexpr int NBUCKET = 15;         // digit values 1..15; digit 0 is skipped
constexpr int BUCKET_LANES = 128;   // lanes (threads) per msm_bucket block
constexpr int BUCKET_MAX_STEPS = 64;  // the largest B msm_bucket takes
constexpr int MERGE_THREADS = 128;  // threads per msm_merge block
constexpr int MERGE_WARPS = MERGE_THREADS / 32;
// msm_merge gives each (job, slot) G threads, G a power of two >= 32, so
// that all of them come to about this many: 512 per SM of an H100's 132,
// four blocks of 128 threads each (the kernel's launch bound). A
// constant, not the device's SM count, so the plain version and the CPU
// tests reproduce G.
constexpr int MERGE_TARGET_THREADS = 132 * 512;
constexpr int WSUM_THREADS = 128;    // threads per msm_wsum block
constexpr int WSUM_MAX_SLOTS = 32;   // a job's slots fit one warp
// to_affine: threads per block and points per thread. 1,034,368 points
// (the blake3-nova key) make 253 blocks of 4,096 points, within the 264
// that fit the card at once at two blocks an SM: every block's Fermat
// chain runs in the one wave.
constexpr int AFFINE_THREADS = 256;
constexpr int AFFINE_PER_THREAD = 16;
constexpr int AFFINE_BLOCK = AFFINE_THREADS * AFFINE_PER_THREAD;

// Blocks of `threads` threads that cover n launch indices.
static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

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

// Base t of lane l (time-major layout, n_lanes innermost).
HP_HD void load_base(const u32* bases, size_t L, int t, int l, Aff& q) {
  const u32* bt = bases + (size_t)t * 2 * NW * L + l;
  for (int k = 0; k < NW; ++k) {
    q.x[k] = bt[(size_t)k * L];
    q.y[k] = bt[(size_t)(NW + k) * L];
  }
}

// The t-split's bucket body (msm_designs.cu) over
// steps [t0, t1) of lane l of job j: stream the bases in order and
// mixed-add each into the bucket its digit selects (buckets start at the
// identity, 15 of them in local memory); store them at lane `ol` of an
// output with `out_lanes` lanes. The t-split runs set h's range into lane
// h * n_lanes + l.
HP_HD void bucket_range(const Consts& c, const int* digits, const u32* bases,
                        u32* buckets, int B, int n_lanes, int j, int l,
                        int t0, int t1, int ol, int out_lanes) {
  Proj bk[NBUCKET];
  for (int s = 0; s < NBUCKET; ++s) pt_identity(c, bk[s]);
  const size_t L = (size_t)n_lanes;
  for (int t = t0; t < t1; ++t) {
    int d = digits[((size_t)j * B + t) * L + l];
    if (d <= 0 || d > NBUCKET) continue;
    Aff q;
    load_base(bases, L, t, l, q);
    pt_add_mixed(c, bk[d - 1], q, bk[d - 1]);
  }
  const size_t OL = (size_t)out_lanes;
  for (int s = 0; s < NBUCKET; ++s)
    store_proj(buckets + ((size_t)j * NBUCKET + s) * 3 * NW * OL + ol, OL,
               bk[s]);
}

// G, the number of msm_merge threads per (job, slot): the largest power
// of two (at least 32) for which J * S * G stays within
// MERGE_TARGET_THREADS, but no more than the lanes rounded up to a power
// of two, and at most MERGE_THREADS^2 (P = G / MERGE_THREADS blocks of a
// slot leave P partials, which the last block sums in one pass). Below
// MERGE_THREADS a block serves MERGE_THREADS / G slots.
HP_HD int merge_group(int J, int S, int n_lanes) {
  const long long js = (long long)J * S;
  const long long want = js > 0 ? MERGE_TARGET_THREADS / js : 0;
  long long g = 32, cap = 32;
  while (g * 2 <= want) g *= 2;
  while (cap < n_lanes) cap *= 2;
  if (g > cap) g = cap;
  if (g > (long long)MERGE_THREADS * MERGE_THREADS)
    g = (long long)MERGE_THREADS * MERGE_THREADS;
  return (int)g;
}

// acc += q with the identity skipped on either side: a q whose Z is 0 adds
// nothing, and an acc whose Z is 0 takes q as it is. The affine sum is
// pt_add's; the projective representative may differ.
HP_HD void acc_add(const Consts& c, Proj& acc, const Proj& q) {
  if (fe_is_zero(q.z)) return;
  if (fe_is_zero(acc.z)) {
    acc = q;
    return;
  }
  pt_add(c, acc, q, acc);
}

// Base t of lane l in the lane-major layout: a lane's B points lie
// contiguous, 64 B each, read as four 16-byte vectors on the card.
HP_HD void load_base_lm(const u32* bases_lm, int B, int t, int l, Aff& q) {
  const u32* p = bases_lm + ((size_t)l * B + t) * 2 * NW;
#ifdef __CUDA_ARCH__
  const uint4* v = reinterpret_cast<const uint4*>(p);
  const uint4 a = __ldg(v), b = __ldg(v + 1), e = __ldg(v + 2),
              f = __ldg(v + 3);
  const u32 w[2 * NW] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                         e.x, e.y, e.z, e.w, f.x, f.y, f.z, f.w};
#else
  const u32* w = p;
#endif
  for (int k = 0; k < NW; ++k) {
    q.x[k] = w[k];
    q.y[k] = w[NW + k];
  }
}

// K1 body for lane l of job j. A counting sort of the lane's digit column
// lists its nonzero steps grouped by digit, ascending in step within a
// digit. One loop then walks that list with one projective accumulator: it
// mixed-adds base t at each step, and where the digit changes it keeps the
// accumulator as that digit's bucket and restarts from the identity. Every
// bucket so receives the same adds in the same order as in bucket_range,
// and the output is bit-equal to it. The finished buckets wait in `done`
// (local memory) so that the lanes of a warp store bucket s together, in
// one coalesced pass at the end; buckets no digit touched get the
// identity. dig, list and cnt are the thread's own columns (entries
// `stride` bytes apart) of three byte tiles: its B digits, its sorted steps
// and its 16 digit counters; B <= BUCKET_MAX_STEPS fits a byte. The bases
// are read lane-major (load_base_lm): a lane's steps differ from its
// neighbours', so time-major rows would cost a sector per word.
HP_HD void bucket_walk(const Consts& c, const int* digits,
                       const u32* bases_lm, u32* buckets, int B,
                       int n_lanes, int j, int l, unsigned char* dig,
                       unsigned char* list, unsigned char* cnt, int stride) {
  const size_t L = (size_t)n_lanes;
  for (int d = 1; d <= NBUCKET; ++d) cnt[d * stride] = 0;
  for (int t = 0; t < B; ++t) {
    int d = digits[((size_t)j * B + t) * L + l];
    d = (d > 0 && d <= NBUCKET) ? d : 0;
    dig[t * stride] = (unsigned char)d;
    if (d) cnt[d * stride] += 1;
  }
  int n = 0;  // counts -> each digit's first slot in the list
  for (int d = 1; d <= NBUCKET; ++d) {
    const int k = cnt[d * stride];
    cnt[d * stride] = (unsigned char)n;
    n += k;
  }
  for (int t = 0; t < B; ++t) {
    const int d = dig[t * stride];
    if (d) list[cnt[d * stride]++ * stride] = (unsigned char)t;
  }
  Proj done[NBUCKET];
  Proj acc;
  pt_identity(c, acc);
  unsigned touched = 0;
  int cur = 0;
  for (int k = 0; k < n; ++k) {
    const int t = list[k * stride];
    const int d = dig[t * stride];
    if (d != cur) {
      if (cur) {
        done[cur - 1] = acc;
        touched |= 1u << (cur - 1);
        pt_identity(c, acc);
      }
      cur = d;
    }
    Aff q;
    load_base_lm(bases_lm, B, t, l, q);
    pt_add_mixed(c, acc, q, acc);
  }
  if (cur) {
    done[cur - 1] = acc;
    touched |= 1u << (cur - 1);
  }
  u32* out = buckets + (size_t)j * NBUCKET * 3 * NW * L + l;
  for (int s = 0; s < NBUCKET; ++s) {
    if ((touched >> s) & 1u)
      acc = done[s];
    else
      pt_identity(c, acc);
    store_proj(out + (size_t)s * 3 * NW * L, L, acc);
  }
}

// K2 body, first phase: merge thread g of the nthreads = G threads of one
// (job j, slot s) sums lanes g, g + nthreads, ... of that slot with
// acc_add. A lane whose Z is 0 (an empty bucket) costs the load
// of its Z and nothing more.
HP_HD void merge_thread(const Consts& c, const u32* buckets, int S,
                        int n_lanes, int j, int s, int g, int nthreads,
                        Proj& acc) {
  pt_identity(c, acc);
  const size_t L = (size_t)n_lanes;
  const u32* slot = buckets + ((size_t)j * S + s) * 3 * NW * L;
  for (int l = g; l < n_lanes; l += nthreads) {
    Proj q;
    for (int k = 0; k < NW; ++k) q.z[k] = slot[(size_t)(2 * NW + k) * L + l];
    if (fe_is_zero(q.z)) continue;
    for (int k = 0; k < NW; ++k) {
      q.x[k] = slot[(size_t)k * L + l];
      q.y[k] = slot[(size_t)(NW + k) * L + l];
    }
    acc_add(c, acc, q);
  }
}

// K3: a job's S slots sit on G = wsum_group(S) lanes of a warp (32 / G
// jobs a warp). Lane v holds B_{v+1}, slot v of job j, or the identity
// where v >= S or j >= J.
HP_HD int wsum_group(int S) {
  int g = 1;
  while (g < S) g *= 2;
  return g;
}

HP_HD void wsum_lane(const Consts& c, const u32* reduced, int S, int J,
                     long long j, int v, Proj& r) {
  if (j < J && v < S)
    load_proj(reduced + ((size_t)j * S + v) * 3 * NW, 1, r);
  else
    pt_identity(c, r);
}

#ifdef __CUDACC__
// r = lane (this + off)'s point, across the whole warp.
__device__ __forceinline__ void shfl_down_proj(const Proj& a, int off,
                                               Proj& r) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    r.x[k] = __shfl_down_sync(0xffffffffu, a.x[k], off);
    r.y[k] = __shfl_down_sync(0xffffffffu, a.y[k], off);
    r.z[k] = __shfl_down_sync(0xffffffffu, a.z[k], off);
  }
}

// K3's schedule over the G lanes of a job (G divides 32; every lane of the
// warp calls it): lane v holds B_{v+1} on entry; an inclusive suffix scan
// over log2 G shuffle levels, then a halving tree over log2 G more, leaves
// sum_v v * B_v on lane 0 of the job. Every add with the identity on one
// side is skipped. The host replay is hc_msm_wsum.
__device__ __forceinline__ void wsum_lanes(const Consts& c, Proj& acc, int v,
                                           int G) {
#pragma unroll 1
  for (int off = 1; off < G; off <<= 1) {  // T_v = B_v + ... + B_S
    Proj o;
    shfl_down_proj(acc, off, o);
    if (v + off < G) acc_add(c, acc, o);
  }
#pragma unroll 1
  for (int off = G / 2; off > 0; off >>= 1) {  // sum of the T_v
    Proj o;
    shfl_down_proj(acc, off, o);
    if (v < off) acc_add(c, acc, o);
  }
}
#endif  // __CUDACC__

// K4 in three phases over a block of AFFINE_THREADS threads, thread t
// owning the AFFINE_PER_THREAD points i_k = b * AFFINE_BLOCK + k *
// AFFINE_THREADS + t (k = 0, 1, ...; those < n), a warp's points
// contiguous for each k. A Z of 0 counts as 1 in every product.
//
// Phase 1: the running products P_k = Z_0 ... Z_k of the thread's points,
// each written into x[i_k] (x is the scratch; phase 3 overwrites it), and
// q = the last of them (1 if the thread has no point).
HP_HD void affine_prefix(const Consts& c, const u32* Z, u32* x, long long n,
                         long long b, int t, u32* q) {
  bool any = false;
  fe_copy(q, c.one);
  for (int k = 0; k < AFFINE_PER_THREAD; ++k) {
    const long long i = b * AFFINE_BLOCK + (long long)k * AFFINE_THREADS + t;
    if (i >= n) break;
    const u32* z = Z + (size_t)i * NW;
    if (!fe_is_zero(z)) {
      if (any)
        mont_mul(c, q, z, q);
      else
        fe_copy(q, z);
      any = true;
    }
    fe_copy(x + (size_t)i * NW, q);
  }
}

// Phase 2, the block's part after its product scans: pre and suf (T
// entries of NW words) hold the inclusive prefix and suffix products of
// the threads' q. r = the product of every q of the block but thread t's.
HP_HD void affine_others(const Consts& c, const u32* pre, const u32* suf,
                         int t, u32* r) {
  if (t == 0)
    fe_copy(r, suf + NW);
  else if (t == AFFINE_THREADS - 1)
    fe_copy(r, pre + (size_t)(t - 1) * NW);
  else
    mont_mul(c, pre + (size_t)(t - 1) * NW, suf + (size_t)(t + 1) * NW, r);
}

// Phase 3: the back-walk from acc = 1 / q. At point k, 1 / Z_k = acc *
// P_{k-1} (read from x), then acc *= Z_k, and x = X / Z, y = Y / Z; a Z of
// 0 gives (0, 0). Four products a point, beside phase 1's one.
HP_HD void affine_back(const Consts& c, const u32* X, const u32* Y,
                       const u32* Z, u32* x, u32* y, long long n,
                       long long b, int t, const u32* inv_q) {
  u32 acc[NW];
  fe_copy(acc, inv_q);
  for (int k = AFFINE_PER_THREAD - 1; k >= 0; --k) {
    const long long i = b * AFFINE_BLOCK + (long long)k * AFFINE_THREADS + t;
    if (i >= n) continue;
    const size_t o = (size_t)i * NW;
    if (fe_is_zero(Z + o)) {
      fe_zero(x + o);
      fe_zero(y + o);
      continue;
    }
    u32 inv[NW];
    if (k > 0) {
      mont_mul(c, acc, x + o - (size_t)AFFINE_THREADS * NW, inv);
      mont_mul(c, acc, Z + o, acc);
    } else {
      fe_copy(inv, acc);
    }
    mont_mul(c, X + o, inv, x + o);
    mont_mul(c, Y + o, inv, y + o);
  }
}

}  // namespace hp
