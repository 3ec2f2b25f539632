// Host build of the kernels' arithmetic and per-thread bodies, for the CPU
// tests only (tests/test_torch_cuda_host.py builds it with g++ into a
// temporary directory and loads it with ctypes). Each entry point runs the
// same code a CUDA thread runs, over every index of the launch; hc_msm_merge
// replays the kernel's blocks, warp-shuffle and warp trees and last-block
// finish in order.
// Nothing on the prover's path loads this library.
#include <vector>

#include "mont.cuh"
#include "msm_designs.cuh"
#include "points.cuh"
#include "tables.cuh"

using namespace hp;

// k_split_walk for every (job, launch index) of the t-split (ol of
// H * n_lanes) and of the signed digits (H = 1), over lane-major bases;
// each thread's byte columns are its own, as in hc_msm_bucket.
template <int S, bool SIGNED>
static void split_walks(const u32* consts, const int* digits,
                        const u32* bases_lm, u32* buckets, int J, int B,
                        int n_lanes, int H) {
  Consts c = load_consts(consts);
  std::vector<unsigned char> dig(B), list(B), cnt(S + 1);
  for (int j = 0; j < J; ++j)
    for (int ol = 0; ol < H * n_lanes; ++ol)
      split_walk<S, SIGNED>(c, digits, bases_lm, buckets, B, n_lanes, H, j,
                            ol, dig.data(), list.data(), cnt.data(), 1);
}

// p, q, out: (n, 3, 8) projective; op 0 = add, 1 = mixed add (q's z
// ignored), 2 = double (q ignored), 3 = negate (q ignored). K picks the
// field backend of the adds (Consts or LeanConsts).
template <class K>
static void point_ops(const K& c, const u32* p, const u32* q, u32* out,
                      int n, int op) {
  for (int i = 0; i < n; ++i) {
    Proj a, b, r;
    load_proj(p + (size_t)i * 3 * NW, 1, a);
    load_proj(q + (size_t)i * 3 * NW, 1, b);
    if (op == 0) {
      pt_add(c, a, b, r);
    } else if (op == 1) {
      Aff bq;
      fe_copy(bq.x, b.x);
      fe_copy(bq.y, b.y);
      pt_add_mixed(c, a, bq, r);
    } else if (op == 2) {
      pt_double(c, a, r);
    } else {
      pt_neg(c, a, r);
    }
    store_proj(out + (size_t)i * 3 * NW, 1, r);
  }
}

extern "C" {

void hc_mont_mul(const u32* consts, const u32* a, const u32* b, u32* out,
                 int n) {
  Consts c = load_consts(consts);
  for (int i = 0; i < n; ++i)
    mont_mul(c, a + i * NW, b + i * NW, out + i * NW);
}

void hc_add(const u32* consts, const u32* a, const u32* b, u32* out, int n) {
  Consts c = load_consts(consts);
  for (int i = 0; i < n; ++i) fe_add(c, a + i * NW, b + i * NW, out + i * NW);
}

void hc_sub(const u32* consts, const u32* a, const u32* b, u32* out, int n) {
  Consts c = load_consts(consts);
  for (int i = 0; i < n; ++i) fe_sub(c, a + i * NW, b + i * NW, out + i * NW);
}

void hc_point_op(const u32* consts, const u32* p, const u32* q, u32* out,
                 int n, int op) {
  point_ops(load_consts(consts), p, q, out, n, op);
}

// msm.cuh's launch constants, in the order NBUCKET, BUCKET_LANES,
// BUCKET_MAX_STEPS, MERGE_THREADS, MERGE_TARGET_THREADS, WSUM_THREADS,
// WSUM_MAX_SLOTS, AFFINE_THREADS, AFFINE_PER_THREAD; merge_group and
// wsum_group.
void hc_msm_constants(int* out) {
  const int v[] = {NBUCKET,        BUCKET_LANES,   BUCKET_MAX_STEPS,
                   MERGE_THREADS,  MERGE_TARGET_THREADS, WSUM_THREADS,
                   WSUM_MAX_SLOTS, AFFINE_THREADS, AFFINE_PER_THREAD};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

int hc_merge_group(int J, int S, int n_lanes) {
  return merge_group(J, S, n_lanes);
}

int hc_wsum_group(int S) { return wsum_group(S); }

// bucket_walk for every (job, lane) over lane-major bases; each thread's
// byte columns are its own, so one set of stride-1 columns serves them in
// turn.
void hc_msm_bucket(const u32* consts, const int* digits, const u32* bases_lm,
                   u32* buckets, int J, int B, int n_lanes) {
  Consts c = load_consts(consts);
  std::vector<unsigned char> dig(B), list(B), cnt(NBUCKET + 1);
  for (int j = 0; j < J; ++j)
    for (int l = 0; l < n_lanes; ++l)
      bucket_walk<NBUCKET, false>(c, digits, bases_lm, buckets, B, n_lanes,
                                  j, l, 0, B, l, n_lanes, dig.data(),
                                  list.data(), cnt.data(), 1);
}

// k_msm_merge's group_sum over the n = 32 * nw accumulators v[0..n) of
// one group: 5 levels in each warp (lane i < off takes lane i + off), then
// the same over the nw warp sums. Returns the sum.
static Proj group_sum(const Consts& c, Proj* v, int nw) {
  std::vector<Proj> ws(nw);
  for (int w = 0; w < nw; ++w) {
    Proj* lane = v + 32 * w;
    for (int off = 16; off > 0; off >>= 1)
      for (int i = 0; i < off; ++i) acc_add(c, lane[i], lane[i + off]);
    ws[w] = lane[0];
  }
  for (int off = nw / 2; off > 0; off >>= 1)
    for (int i = 0; i < off; ++i) acc_add(c, ws[i], ws[i + off]);
  return ws[0];
}

// k_msm_merge slot by slot: the G threads' strided sums, then their group
// sum (G <= MERGE_THREADS), or the group sums of the P = G /
// MERGE_THREADS blocks and the last block's sum of those P partials
// padded with the identity.
void hc_msm_merge(const u32* consts, const u32* buckets, u32* reduced, int J,
                  int S, int n_lanes) {
  Consts c = load_consts(consts);
  const int G = merge_group(J, S, n_lanes);
  std::vector<Proj> v(G), part(MERGE_THREADS);
  for (int js = 0; js < J * S; ++js) {
    for (int g = 0; g < G; ++g)
      merge_thread(c, buckets, S, n_lanes, js / S, js % S, g, G, v[g]);
    Proj r;
    if (G <= MERGE_THREADS) {
      r = group_sum(c, v.data(), G / 32);
    } else {
      const int P = G / MERGE_THREADS;
      for (int p = 0; p < MERGE_THREADS; ++p) {
        if (p < P)
          part[p] = group_sum(c, &v[p * MERGE_THREADS], MERGE_WARPS);
        else
          pt_identity(c, part[p]);
      }
      r = group_sum(c, part.data(), MERGE_WARPS);
    }
    store_proj(reduced + (size_t)js * 3 * NW, 1, r);
  }
}

// k_msm_wsum warp by warp: the G lanes of each of the warp's 32 / G jobs
// load their slots (wsum_lane), then each shuffle level of the suffix scan
// (lane v < G - off takes lane v + off, all reading the level's inputs)
// and of the halving tree (lane v < off takes lane v + off).
void hc_msm_wsum(const u32* consts, const u32* reduced, u32* out, int J,
                 int S) {
  Consts c = load_consts(consts);
  const int G = wsum_group(S);
  std::vector<Proj> lane(32), prev(32);
  for (long long w0 = 0; w0 < J; w0 += 32 / G) {
    for (int l = 0; l < 32; ++l)
      wsum_lane(c, reduced, S, J, w0 + l / G, l % G, lane[l]);
    for (int off = 1; off < G; off <<= 1) {
      prev = lane;
      for (int l = 0; l < 32; ++l)
        if (l % G + off < G) acc_add(c, lane[l], prev[l + off]);
    }
    for (int off = G / 2; off > 0; off >>= 1)
      for (int l = 0; l < 32; ++l)
        if (l % G < off) acc_add(c, lane[l], lane[l + off]);
    for (int l = 0; l < 32; l += G)
      if (w0 + l / G < J)
        store_proj(out + (size_t)(w0 + l / G) * 3 * NW, 1, lane[l]);
  }
}

// k_msm_chain lane by lane: its H sub-chains (chain_part), then their
// halving tree (chain_join), on the lean backend's host branch.
void hc_msm_chain(const u32* lean_consts, const u32* bases, u32* out, int J,
                  int B, int n_lanes, int H) {
  LeanConsts c = load_lean_consts(lean_consts);
  std::vector<Proj> part(H);
  const size_t L = (size_t)n_lanes;
  for (int j = 0; j < J; ++j)
    for (int l = 0; l < n_lanes; ++l) {
      for (int h = 0; h < H; ++h)
        chain_part(c, bases, B, n_lanes, H, l, h, part[h]);
      chain_join(c, part.data(), H);
      store_proj(out + (size_t)j * 3 * NW * L + l, L, part[0]);
    }
}

void hc_msm_bucket_tsplit(const u32* consts, const int* digits,
                          const u32* bases_lm, u32* buckets, int J, int B,
                          int n_lanes, int H) {
  split_walks<NBUCKET, false>(consts, digits, bases_lm, buckets, J, B,
                              n_lanes, H);
}

void hc_msm_bucket_signed(const u32* consts, const int* digits,
                          const u32* bases_lm, u32* buckets, int J, int B,
                          int n_lanes) {
  split_walks<NSIGNED, true>(consts, digits, bases_lm, buckets, J, B,
                             n_lanes, 1);
}

// k_to_affine block by block: every thread's phase 1, the prefix and
// suffix product scans level by level (each level reading the one before),
// thread 0's inversion of the block's product, every thread's phase 3.
void hc_to_affine(const u32* consts, const u32* X, const u32* Y, const u32* Z,
                  u32* x, u32* y, long long n) {
  Consts c = load_consts(consts);
  const int T = AFFINE_THREADS;
  std::vector<u32> pre(T * NW), suf(T * NW), p0, s0;
  for (long long b = 0; b * AFFINE_BLOCK < n; ++b) {
    for (int t = 0; t < T; ++t) {
      affine_prefix(c, Z, x, n, b, t, &pre[t * NW]);
      fe_copy(&suf[t * NW], &pre[t * NW]);
    }
    for (int off = 1; off < T; off <<= 1) {
      p0 = pre;
      s0 = suf;
      for (int t = 0; t < T; ++t) {
        if (t >= off) mont_mul(c, &p0[(t - off) * NW], &p0[t * NW],
                               &pre[t * NW]);
        if (t + off < T) mont_mul(c, &s0[t * NW], &s0[(t + off) * NW],
                                  &suf[t * NW]);
      }
    }
    u32 inv[NW], others[NW], inv_q[NW];
    fe_inv(c, &pre[(T - 1) * NW], inv);
    for (int t = 0; t < T; ++t) {
      affine_others(c, pre.data(), suf.data(), t, others);
      mont_mul(c, inv, others, inv_q);
      affine_back(c, X, Y, Z, x, y, n, b, t, inv_q);
    }
  }
}

// The field-multiply kernels' bodies (mont.cuh), one call per launch index.
// a, b and out are int32 in `layout` (1 limb-major digits, 2 words; the
// element-major kernel is hc_mont_mul_em_tiled); a and b hold na and nb
// elements (broadcast if < n).
void hc_mont_mul_fmt(const u32* fconsts, const int* a, long long na,
                     const int* b, long long nb, int* out, long long n,
                     int layout) {
  FieldConsts f = load_field_consts(fconsts);
  for (long long i = 0; i < n; ++i)
    mont_mul_elem(f, a, (size_t)na, b, (size_t)nb, out, (size_t)n, (size_t)i,
                  layout);
}

// k_mont_mul_em replayed block by block: every thread's share of staging
// the tile in, then every thread's product, then the staging out, in the
// kernel's order between its barriers.
void hc_mont_mul_em_tiled(const u32* fconsts, const int* a, long long na,
                          const int* b, long long nb, int* out,
                          long long n) {
  FieldConsts f = load_field_consts(fconsts);
  std::vector<u32> sa(EM_TILE * EM_PITCH), sb(EM_TILE * EM_PITCH);
  std::vector<u32> x(EM_TILE * NW);
  const size_t N = (size_t)n;
  for (size_t base = 0; base < N; base += EM_TILE) {
    for (int tid = 0; tid < EM_TILE; ++tid) {
      if (na == n) em_tile_load(a, N, base, tid, sa.data());
      if (nb == n) em_tile_load(b, N, base, tid, sb.data());
    }
    for (int tid = 0; tid < EM_TILE; ++tid)
      if (base + tid < N)
        em_tile_product(f, sa.data(), sb.data(), a, (size_t)na, b,
                        (size_t)nb, N, base + tid, tid, &x[tid * NW]);
    for (int tid = 0; tid < EM_TILE; ++tid)
      if (base + tid < N)
        for (int k = 0; k < NW; ++k) sa[tid * EM_PITCH + k] = x[tid * NW + k];
    for (int tid = 0; tid < EM_TILE; ++tid)
      em_tile_store(out, N, base, tid, sa.data());
  }
}

void hc_mont_mul_stage(const u32* fconsts, const int* a, const int* b,
                       int* out, long long n, int stage) {
  FieldConsts f = load_field_consts(fconsts);
  for (long long i = 0; i < n; ++i)
    stage_elem(f, a, b, out, (size_t)n, (size_t)i, stage);
}

void hc_mont_mul_part(const u32* fconsts, const int* a, const int* b,
                      int* out, long long n, int part) {
  FieldConsts f = load_field_consts(fconsts);
  for (long long i = 0; i < n; ++i)
    part_elem(f, a, b, out, (size_t)n, (size_t)i, part);
}

// The variable-base kernel (points.cuh), one call per point: scale16
// (pts (n, 3, 8) -> out (W4, n, 3, 8)).
void hc_scale16(const u32* consts, const u32* pts, u32* out, long long n,
                int windows) {
  Consts c = load_consts(consts);
  for (long long i = 0; i < n; ++i)
    scale16_point(c, pts, out, n, i, windows);
}

// The matrix-table kernel (tables.cuh), one warp a row in `order`: each
// lane's walk (table_lane), the halving trees over each value's parts
// level by level (every lane reading the level's inputs, as the shuffles
// do), the gather of value v's sum to lane v - 1, then K3's lane schedule
// at G = 16 replayed as hc_msm_wsum does.
void hc_h_tables(const u32* lean_consts, const int* row_ptr,
                 const int* order, const int* alloc, const int* cols,
                 const u32* mag, const int* neg, const u32* bases_lm,
                 u32* out, int R, int B, int lpw) {
  LeanConsts c = load_lean_consts(lean_consts);
  std::vector<Proj> lane(TABLE_LANES), prev(TABLE_LANES);
  std::vector<TableLane> map(TABLE_LANES);
  for (int wi = 0; wi < R; ++wi) {
    const int row = order[wi];
    for (int l = 0; l < TABLE_LANES; ++l) {
      map[l] = table_lane_map(alloc + (size_t)row * 4, l);
      table_lane(c, row_ptr, alloc, cols, mag, neg, bases_lm, B, lpw, row,
                 l, lane[l]);
    }
    for (int off = 1; off < map[0].amax; off <<= 1) {
      prev = lane;
      for (int l = 0; l < TABLE_LANES; ++l)
        if (table_seg_takes(map[l], off)) acc_add(c, lane[l], prev[l + off]);
    }
    prev = lane;
    for (int l = 0; l < TABLE_LANES; ++l) {
      if (l < NBUCKET && map[l].head >= 0)
        lane[l] = prev[map[l].head];
      else
        pt_identity(c, lane[l]);
    }
    for (int off = 1; off < 16; off <<= 1) {
      prev = lane;
      for (int l = 0; l < TABLE_LANES; ++l)
        if (l % 16 + off < 16) acc_add(c, lane[l], prev[l + off]);
    }
    for (int off = 8; off > 0; off >>= 1)
      for (int l = 0; l < TABLE_LANES; ++l)
        if (l % 16 < off) acc_add(c, lane[l], lane[l + off]);
    store_proj(out + (size_t)row * 3 * NW, 1, lane[0]);
  }
}

// The lean field backend's host branch (field_lean.cuh) on n elements:
// op 0 mont_mul, 1 fe_add, 2 fe_sub, 3 mul_b3 (b ignored).
void hc_lean_field(const u32* lean_consts, const u32* a, const u32* b,
                   u32* out, int n, int op) {
  LeanConsts c = load_lean_consts(lean_consts);
  for (int i = 0; i < n; ++i) {
    const u32 *x = a + i * NW, *y = b + i * NW;
    u32* o = out + i * NW;
    if (op == 0)
      mont_mul(c, x, y, o);
    else if (op == 1)
      fe_add(c, x, y, o);
    else if (op == 2)
      fe_sub(c, x, y, o);
    else
      mul_b3(c, x, o);
  }
}

// point_ops on the lean backend (ops 0 and 1 are its adds).
void hc_lean_point_op(const u32* lean_consts, const u32* p, const u32* q,
                      u32* out, int n, int op) {
  point_ops(load_lean_consts(lean_consts), p, q, out, n, op);
}

}  // extern "C"
