// Host build of the kernels' arithmetic and per-thread bodies, for the CPU
// tests only (tests/test_torch_cuda_host.py builds it with g++ into a
// temporary directory and loads it with ctypes). Each entry point runs the
// same code a CUDA thread runs, over every index of the launch; hc_msm_merge
// replays the kernel's blocks, warp-shuffle and warp trees and last-block
// finish in order.
// Nothing on the prover's path loads this library.
#include <vector>

#include "conv_mma.cuh"
#include "mont.cuh"
#include "msm_designs.cuh"
#include "points.cuh"
#include "poseidon.cuh"
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
// ignored), 2 = negate (q ignored). K picks the field backend of the adds
// (Consts or LeanConsts).
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

// A host model of mma.sync.m16n8k32.row.col.s32.u8.u8.s32 over the 32
// lanes' fragments (the PTX ISA's layout: A 16 x 32 row-major, B 32 x 8
// col-major, C/D 16 x 8), with C = 0: the matrices the fragments spell
// (A[mt] rows 16 mt .. 16 mt + 15 of a 32 x 32, B), their product, and
// each lane's accumulator registers d[lane][mt][0..3].
struct MmaModel {
  unsigned char A[32][32], B[32][8];
  int d[32][2][4];
};

static void model_mma(const u32 (&af)[32][2][4], const u32 (&bf)[32][2],
                      MmaModel& m) {
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    for (int mt = 0; mt < 2; ++mt)
      for (int r = 0; r < 4; ++r)
        for (int i = 0; i < 4; ++i)
          m.A[16 * mt + g + 8 * (r & 1)][4 * t + i + 16 * (r >> 1)] =
              (unsigned char)(af[lane][mt][r] >> (8 * i));
    for (int r = 0; r < 2; ++r)
      for (int i = 0; i < 4; ++i)
        m.B[4 * t + i + 16 * r][g] = (unsigned char)(bf[lane][r] >> (8 * i));
  }
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    for (int mt = 0; mt < 2; ++mt)
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * mt + g + 8 * (r >> 1), col = 2 * t + (r & 1);
        int s = 0;
        for (int k = 0; k < 32; ++k) s += (int)m.A[row][k] * m.B[k][col];
        m.d[lane][mt][r] = s;
      }
  }
}

// One element (a, b: 32 digits each) through the kernel's staging and
// fragment functions (pitch 1) and the mma model: the A (32 x 32) and B
// (32 x 8) the fragments spell, and the 32 columns as the lanes store them
// (a column no lane stores stays -1).
void hc_conv_frags(const int* a, const int* b, unsigned char* A,
                   unsigned char* B, int* cols) {
  u32 pa[CONV_WORDS], rev[CONV_WORDS];
  conv_stage_in(a, b, 1, 0, 0, pa, rev, 1);
  u32 af[32][2][4], bf[32][2];
  for (int lane = 0; lane < 32; ++lane)
    conv_frags(pa, rev, 1, lane, af[lane], bf[lane]);
  static MmaModel m;
  model_mma(af, bf, m);
  for (int i = 0; i < 32 * 32; ++i) A[i] = m.A[i / 32][i % 32];
  for (int i = 0; i < 32 * 8; ++i) B[i] = m.B[i / 8][i % 8];
  for (int c = 0; c < 32; ++c) cols[c] = -1;
  for (int lane = 0; lane < 32; ++lane)
    cols[conv_out_col(lane)] = conv_pick(m.d[lane], lane);
}

// k_conv_mma replayed block by block: every thread's staging in, each
// element's fragments from all 32 lanes, the mma model and each lane's
// store into the tile, then every thread's staging out.
void hc_conv_mma(const int* a, const int* b, int* out, long long n) {
  std::vector<u32> pa(CONV_WORDS * CONV_PITCH), rev(CONV_WORDS * CONV_PITCH);
  std::vector<int> so(CONV_DIGITS * CONV_PITCH);
  static MmaModel m;
  u32 af[32][2][4], bf[32][2];
  for (long long e0 = 0; e0 < n; e0 += CONV_TILE) {
    for (int t = 0; t < CONV_TILE; ++t)
      conv_stage_in(a, b, n, e0, t, pa.data(), rev.data(), CONV_PITCH);
    for (int te = 0; te < CONV_TILE; ++te) {
      for (int lane = 0; lane < 32; ++lane)
        conv_frags(pa.data() + te, rev.data() + te, CONV_PITCH, lane,
                   af[lane], bf[lane]);
      model_mma(af, bf, m);
      for (int lane = 0; lane < 32; ++lane)
        so[conv_out_col(lane) * CONV_PITCH + te] = conv_pick(m.d[lane], lane);
    }
    for (int t = 0; t < CONV_TILE; ++t)
      conv_stage_out(so.data(), out, n, e0, t, CONV_PITCH);
  }
}

// The variable-base kernel (points.cuh), one call per point: scale16
// (pts (n, 3, 8) -> out (W4, n, 3, 8)) on the lean backend's host branch.
void hc_scale16(const u32* lean_consts, const u32* pts, u32* out,
                long long n, int windows) {
  LeanConsts c = load_lean_consts(lean_consts);
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
// op 0 mont_mul, 1 fe_add, 2 fe_sub, 3 mul_b3 (b ignored), 4 the
// squaring, lean_sqr_wide then mont_redc<1> (b ignored), 5 the product
// lean_mul_wide then mont_redc<1>; 6 a^2, b^2 and a b through one
// mont_redc<3> (in out's rows 3i, 3i + 1, 3i + 2; n / 3 triples).
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
    else if (op == 3)
      mul_b3(c, x, o);
    else if (op == 4 || op == 5) {
      u32 t[1][2 * NW];
      if (op == 4)
        lean_sqr_wide(x, t[0]);
      else
        lean_mul_wide(x, y, t[0]);
      mont_redc<1>(c, t);
      fe_copy(o, t[0]);
    }
  }
  if (op != 6) return;
  for (int i = 0; 3 * i + 2 < n; ++i) {
    const u32 *x = a + i * NW, *y = b + i * NW;
    u32 t[3][2 * NW];
    lean_sqr_wide(x, t[0]);
    lean_sqr_wide(y, t[1]);
    lean_mul_wide(x, y, t[2]);
    mont_redc<3>(c, t);
    for (int k = 0; k < 3; ++k) fe_copy(out + (3 * i + k) * NW, t[k]);
  }
}

// point_ops on the lean backend (ops 0 and 1 are its adds).
void hc_lean_point_op(const u32* lean_consts, const u32* p, const u32* q,
                      u32* out, int n, int op) {
  point_ops(load_lean_consts(lean_consts), p, q, out, n, op);
}

// k_poseidon's body for every state of in (n, t, 32) Montgomery digits;
// returns 1 for a t the kernel is not built for.
int hc_poseidon(const u32* fconsts, const u32* rc_mds, int t, int r_full,
                int r_partial, const int* in, int* out, long long n) {
  const LeanConsts c = lean_field_consts(load_field_consts(fconsts));
  for (long long i = 0; i < n; ++i) {
    if (t == 3)
      poseidon_elem<3>(c, rc_mds, r_full, r_partial, in, out, (size_t)i);
    else if (t == 5)
      poseidon_elem<5>(c, rc_mds, r_full, r_partial, in, out, (size_t)i);
    else if (t == 9)
      poseidon_elem<9>(c, rc_mds, r_full, r_partial, in, out, (size_t)i);
    else
      return 1;
  }
  return 0;
}

}  // extern "C"
