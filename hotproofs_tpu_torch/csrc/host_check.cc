// Host build of the kernels' arithmetic and per-thread bodies, for the CPU
// tests only (tests/test_torch_cuda_host.py builds it with g++ into a
// temporary directory and loads it with ctypes). Each entry point runs the
// same code a CUDA thread runs, over every index of the launch; hc_msm_merge
// replays the kernel's strided accumulation and shared-memory tree in order.
// Nothing on the prover's path loads this library.
#include <vector>

#include "msm.cuh"

using namespace hp;

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

// p, q, out: (n, 3, 8) projective; op 0 = add, 1 = mixed add (q's z
// ignored), 2 = double (q ignored), 3 = negate (q ignored).
void hc_point_op(const u32* consts, const u32* p, const u32* q, u32* out,
                 int n, int op) {
  Consts c = load_consts(consts);
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

void hc_msm_bucket(const u32* consts, const int* digits, const u32* bases,
                   u32* buckets, int J, int B, int n_lanes) {
  Consts c = load_consts(consts);
  for (int j = 0; j < J; ++j)
    for (int l = 0; l < n_lanes; ++l)
      bucket_lane(c, digits, bases, buckets, B, n_lanes, j, l);
}

void hc_msm_merge(const u32* consts, const u32* buckets, u32* reduced, int J,
                  int n_lanes) {
  Consts c = load_consts(consts);
  std::vector<Proj> sh(MERGE_THREADS);
  for (int js = 0; js < J * NBUCKET; ++js) {
    int j = js / NBUCKET, s = js % NBUCKET;
    for (int tid = 0; tid < MERGE_THREADS; ++tid)
      merge_thread(c, buckets, n_lanes, j, s, tid, MERGE_THREADS, sh[tid]);
    for (int h = MERGE_THREADS / 2; h > 0; h >>= 1)
      for (int tid = 0; tid < h; ++tid)
        pt_add(c, sh[tid], sh[tid + h], sh[tid]);
    store_proj(reduced + (size_t)js * 3 * NW, 1, sh[0]);
  }
}

void hc_msm_wsum(const u32* consts, const u32* reduced, u32* out, int J) {
  Consts c = load_consts(consts);
  for (int j = 0; j < J; ++j) wsum_job(c, reduced, out, j);
}

void hc_to_affine(const u32* consts, const u32* X, const u32* Y, const u32* Z,
                  u32* x, u32* y, long long n) {
  Consts c = load_consts(consts);
  for (long long i = 0; i < n; ++i) affine_point(c, X, Y, Z, x, y, (size_t)i);
}

}  // extern "C"
