// Native 256-bit field / Poseidon / short-Weierstrass EC helpers for the
// host side of the Nova fold loop.
//
// The reference gets these from neptune/pasta_curves (Rust, SURVEY.md §2b);
// in this stack the per-fold Fiat-Shamir transcript and the host instance
// fold were pure-Python bigints — measured 24.8 ms (transcript) + 6.1 ms
// (instance fold) per fold on this host (tools/profile_msm_phases.py), which
// at lockstep K=8 is ~250 ms of host work per step, comparable to the device
// MSM itself. This module runs the same math at C speed; the Python oracles
// remain the reference semantics and the fallback.
//
// Everything is runtime-parameterized (modulus, Poseidon constants, curve b)
// so the Pasta and BN254/Grumpkin cycles share one binary. Numbers cross the
// ABI as 32-byte little-endian buffers in REGULAR (non-Montgomery) form.

#include <cstdint>
#include <cstring>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

namespace {

struct Fp { u64 v[4]; };

static inline bool fp_is_zero(const Fp &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline bool fp_eq(const Fp &a, const Fp &b) {
  return a.v[0] == b.v[0] && a.v[1] == b.v[1] && a.v[2] == b.v[2] &&
         a.v[3] == b.v[3];
}

static inline bool geq(const u64 a[4], const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}

static inline void sub4(u64 a[4], const u64 b[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - (u64)borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

struct FieldCtx {
  u64 p[4];
  u64 n0inv;     // -p^{-1} mod 2^64
  Fp r2;         // R^2 mod p (R = 2^256)
  Fp one_mont;   // R mod p
  u64 pm2[4];    // p - 2 (Fermat inversion exponent)
};

static std::vector<FieldCtx> g_fields;

static inline void mont_mul(const FieldCtx &F, const Fp &a, const Fp &b,
                            Fp &out) {
  // CIOS, 4x64.
  u64 t[5] = {0, 0, 0, 0, 0};
  u64 t_extra = 0;
  for (int i = 0; i < 4; ++i) {
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)a.v[i] * b.v[j] + t[j] + (u64)c;
      t[j] = (u64)s;
      c = s >> 64;
    }
    u128 s = (u128)t[4] + (u64)c;
    t[4] = (u64)s;
    t_extra = (u64)(s >> 64);

    u64 m = t[0] * F.n0inv;
    c = ((u128)m * F.p[0] + t[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)m * F.p[j] + t[j] + (u64)c;
      t[j - 1] = (u64)s2;
      c = s2 >> 64;
    }
    u128 s3 = (u128)t[4] + (u64)c;
    t[3] = (u64)s3;
    t[4] = t_extra + (u64)(s3 >> 64);
  }
  if (t[4] || geq(t, F.p)) sub4(t, F.p);
  out.v[0] = t[0]; out.v[1] = t[1]; out.v[2] = t[2]; out.v[3] = t[3];
}

static inline void fp_add(const FieldCtx &F, const Fp &a, const Fp &b,
                          Fp &out) {
  u64 t[4];
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + (u64)carry;
    t[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || geq(t, F.p)) sub4(t, F.p);
  memcpy(out.v, t, sizeof(t));
}

static inline void fp_sub(const FieldCtx &F, const Fp &a, const Fp &b,
                          Fp &out) {
  u64 t[4];
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - (u64)borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)t[i] + F.p[i] + (u64)carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
  }
  memcpy(out.v, t, sizeof(t));
}

static void fp_pow(const FieldCtx &F, const Fp &base, const u64 e[4],
                   Fp &out) {
  Fp acc = F.one_mont;
  Fp sq = base;
  for (int w = 0; w < 4; ++w) {
    u64 bits = e[w];
    for (int i = 0; i < 64; ++i) {
      if (bits & 1) mont_mul(F, acc, sq, acc);
      bits >>= 1;
      if (w == 3 && bits == 0) break;
      mont_mul(F, sq, sq, sq);
    }
  }
  out = acc;
}

static inline void fp_inv(const FieldCtx &F, const Fp &a, Fp &out) {
  fp_pow(F, a, F.pm2, out);  // 0 -> 0
}

static void to_mont(const FieldCtx &F, const Fp &a, Fp &out) {
  mont_mul(F, a, F.r2, out);
}

static void from_mont(const FieldCtx &F, const Fp &a, Fp &out) {
  Fp one = {{1, 0, 0, 0}};
  mont_mul(F, a, one, out);
}

static void load_le(const uint8_t *b, Fp &out) {
  memcpy(out.v, b, 32);  // little-endian host assumed (x86/ARM LE)
}

static void store_le(const Fp &a, uint8_t *b) { memcpy(b, a.v, 32); }

// --------------------------------------------------------------------------
// Poseidon
// --------------------------------------------------------------------------

struct PoseidonCtx {
  int field;
  int t, rf, rp;
  std::vector<Fp> rc;   // (rounds * t), Montgomery
  std::vector<Fp> mds;  // (t * t), Montgomery
};

static std::vector<PoseidonCtx> g_poseidons;

static void pow5(const FieldCtx &F, Fp &x) {
  Fp x2, x4;
  mont_mul(F, x, x, x2);
  mont_mul(F, x2, x2, x4);
  mont_mul(F, x4, x, x);
}

static void permute(const PoseidonCtx &P, Fp *s /* t elems, Montgomery */) {
  const FieldCtx &F = g_fields[P.field];
  const int t = P.t;
  const int half = P.rf / 2;
  const int rounds = P.rf + P.rp;
  Fp tmp[16];
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const Fp *rc = &P.rc[rnd * t];
    for (int i = 0; i < t; ++i) fp_add(F, s[i], rc[i], s[i]);
    bool full = rnd < half || rnd >= half + P.rp;
    if (full) {
      for (int i = 0; i < t; ++i) pow5(F, s[i]);
    } else {
      pow5(F, s[0]);
    }
    for (int i = 0; i < t; ++i) {
      Fp acc = {{0, 0, 0, 0}};
      const Fp *row = &P.mds[i * t];
      for (int j = 0; j < t; ++j) {
        Fp prod;
        mont_mul(F, row[j], s[j], prod);
        fp_add(F, acc, prod, acc);
      }
      tmp[i] = acc;
    }
    for (int i = 0; i < t; ++i) s[i] = tmp[i];
  }
}

// --------------------------------------------------------------------------
// Curve (short Weierstrass, a = 0), projective RCB15 — identical formulas to
// ops/curve.py _host_proj_add so native and Python paths agree bit-for-bit.
// --------------------------------------------------------------------------

struct CurveCtx {
  int field;     // base field
  Fp b3_mont;
};

static std::vector<CurveCtx> g_curves;

struct Pt { Fp X, Y, Z; };  // Montgomery coords; identity = (0, 1, 0)

static void pt_identity(const FieldCtx &F, Pt &p) {
  memset(&p, 0, sizeof(p));
  p.Y = F.one_mont;
}

static void pt_add(const CurveCtx &C, const Pt &P, const Pt &Q, Pt &R) {
  const FieldCtx &F = g_fields[C.field];
  const Fp &b3 = C.b3_mont;
  Fp t0, t1, t2, t3, t4, t5, X3, Y3, Z3;
  mont_mul(F, P.X, Q.X, t0);
  mont_mul(F, P.Y, Q.Y, t1);
  mont_mul(F, P.Z, Q.Z, t2);
  fp_add(F, P.X, P.Y, t3);
  fp_add(F, Q.X, Q.Y, t4);
  mont_mul(F, t3, t4, t3);
  fp_add(F, t0, t1, t4);
  fp_sub(F, t3, t4, t3);
  fp_add(F, P.Y, P.Z, t4);
  fp_add(F, Q.Y, Q.Z, t5);
  mont_mul(F, t4, t5, t4);
  fp_add(F, t1, t2, t5);
  fp_sub(F, t4, t5, t4);
  fp_add(F, P.X, P.Z, X3);
  fp_add(F, Q.X, Q.Z, Y3);
  mont_mul(F, X3, Y3, X3);
  fp_add(F, t0, t2, Y3);
  fp_sub(F, X3, Y3, Y3);
  fp_add(F, t0, t0, X3);
  fp_add(F, X3, t0, t0);
  mont_mul(F, t2, b3, t2);
  fp_add(F, t1, t2, Z3);
  fp_sub(F, t1, t2, t1);
  mont_mul(F, Y3, b3, Y3);
  mont_mul(F, t4, Y3, X3);
  Fp u;
  mont_mul(F, t3, t1, u);
  fp_sub(F, u, X3, X3);
  mont_mul(F, Y3, t0, Y3);
  mont_mul(F, t1, Z3, t1);
  fp_add(F, t1, Y3, Y3);
  mont_mul(F, t0, t3, t0);
  mont_mul(F, Z3, t4, Z3);
  fp_add(F, Z3, t0, Z3);
  R.X = X3; R.Y = Y3; R.Z = Z3;
}

static void pt_scalar_mul(const CurveCtx &C, const u64 k[4], const Pt &P,
                          Pt &R) {
  const FieldCtx &F = g_fields[C.field];
  Pt acc;
  pt_identity(F, acc);
  Pt base = P;
  for (int w = 0; w < 4; ++w) {
    u64 bits = k[w];
    for (int i = 0; i < 64; ++i) {
      if (bits & 1) pt_add(C, acc, base, acc);
      bits >>= 1;
      if (w == 3 && bits == 0) break;
      pt_add(C, base, base, base);
    }
  }
  R = acc;
}

}  // namespace

extern "C" {

// Returns a field handle for modulus p (32B LE); handles are memoized.
int ffec_field(const uint8_t *p_le) {
  Fp p;
  load_le(p_le, p);
  for (size_t i = 0; i < g_fields.size(); ++i) {
    if (fp_eq(*(Fp *)g_fields[i].p, p)) return (int)i;
  }
  FieldCtx F;
  memcpy(F.p, p.v, 32);
  // n0inv = -p^{-1} mod 2^64 via Newton iteration.
  u64 inv = 1;
  for (int i = 0; i < 6; ++i) inv *= 2 - F.p[0] * inv;
  F.n0inv = ~inv + 1;
  // r = 2^256 mod p by repeated doubling of (2^255 mod p-ish): start from
  // 1, double 256 times with conditional subtract.
  u64 r[4] = {1, 0, 0, 0};
  for (int i = 0; i < 256; ++i) {
    u64 carry = r[3] >> 63;
    r[3] = (r[3] << 1) | (r[2] >> 63);
    r[2] = (r[2] << 1) | (r[1] >> 63);
    r[1] = (r[1] << 1) | (r[0] >> 63);
    r[0] <<= 1;
    if (carry || geq(r, F.p)) sub4(r, F.p);
  }
  memcpy(F.one_mont.v, r, 32);
  memcpy(F.pm2, F.p, 32);
  u64 two[4] = {2, 0, 0, 0};
  sub4(F.pm2, two);
  // r2 = r * r / R ... easiest: square via doubling again (r2 = 2^512 mod p)
  u64 r2[4];
  memcpy(r2, r, 32);
  for (int i = 0; i < 256; ++i) {
    u64 carry = r2[3] >> 63;
    r2[3] = (r2[3] << 1) | (r2[2] >> 63);
    r2[2] = (r2[2] << 1) | (r2[1] >> 63);
    r2[1] = (r2[1] << 1) | (r2[0] >> 63);
    r2[0] <<= 1;
    if (carry || geq(r2, F.p)) sub4(r2, F.p);
  }
  memcpy(F.r2.v, r2, 32);
  g_fields.push_back(F);
  return (int)g_fields.size() - 1;
}

// Poseidon instance: constants as (rounds*t + t*t) 32B LE regular values.
int ffec_poseidon(int fid, int t, int rf, int rp, const uint8_t *rc_le,
                  const uint8_t *mds_le) {
  if (fid < 0 || fid >= (int)g_fields.size() || t > 16) return -1;
  const FieldCtx &F = g_fields[fid];
  PoseidonCtx P;
  P.field = fid;
  P.t = t; P.rf = rf; P.rp = rp;
  int rounds = rf + rp;
  P.rc.resize(rounds * t);
  P.mds.resize(t * t);
  for (int i = 0; i < rounds * t; ++i) {
    Fp v; load_le(rc_le + 32 * i, v);
    to_mont(F, v, P.rc[i]);
  }
  for (int i = 0; i < t * t; ++i) {
    Fp v; load_le(mds_le + 32 * i, v);
    to_mont(F, v, P.mds[i]);
  }
  g_poseidons.push_back(std::move(P));
  return (int)g_poseidons.size() - 1;
}

// Sponge absorb, HostSponge semantics (ops/poseidon.py:289-296): add into
// rate lanes round-robin, permute after each full rate block. state = t*32B
// LE regular, modified in place. Returns the new absorbed counter.
long long ffec_absorb(int pid, uint8_t *state_le, long long absorbed,
                      const uint8_t *vals_le, long long n) {
  const PoseidonCtx &P = g_poseidons[pid];
  const FieldCtx &F = g_fields[P.field];
  const int t = P.t, rate = P.t - 1;
  Fp s[16];
  for (int i = 0; i < t; ++i) {
    Fp v; load_le(state_le + 32 * i, v);
    to_mont(F, v, s[i]);
  }
  for (long long k = 0; k < n; ++k) {
    Fp v; load_le(vals_le + 32 * k, v);
    to_mont(F, v, v);
    int lane = 1 + (int)(absorbed % rate);
    fp_add(F, s[lane], v, s[lane]);
    ++absorbed;
    if (absorbed % rate == 0) permute(P, s);
  }
  for (int i = 0; i < t; ++i) {
    Fp v; from_mont(F, s[i], v);
    store_le(v, state_le + 32 * i);
  }
  return absorbed;
}

// Sponge squeeze, HostSponge semantics (ops/poseidon.py:298-303). Writes the
// squeezed element to out_le; returns the new absorbed counter.
long long ffec_squeeze(int pid, uint8_t *state_le, long long absorbed,
                       uint8_t *out_le) {
  const PoseidonCtx &P = g_poseidons[pid];
  const FieldCtx &F = g_fields[P.field];
  const int t = P.t, rate = P.t - 1;
  Fp s[16];
  for (int i = 0; i < t; ++i) {
    Fp v; load_le(state_le + 32 * i, v);
    to_mont(F, v, s[i]);
  }
  if (absorbed % rate != 0) {
    permute(P, s);
    absorbed = 0;
  }
  permute(P, s);
  for (int i = 0; i < t; ++i) {
    Fp v; from_mont(F, s[i], v);
    store_le(v, state_le + 32 * i);
  }
  memcpy(out_le, state_le + 32, 32);
  return absorbed;
}

int ffec_curve(int fid_base, const uint8_t *b_le) {
  if (fid_base < 0 || fid_base >= (int)g_fields.size()) return -1;
  const FieldCtx &F = g_fields[fid_base];
  CurveCtx C;
  C.field = fid_base;
  Fp b; load_le(b_le, b);
  Fp b3; fp_add(F, b, b, b3); fp_add(F, b3, b, b3);
  to_mont(F, b3, C.b3_mont);
  g_curves.push_back(C);
  return (int)g_curves.size() - 1;
}

// acc := acc + r * Q (affine LE coords; *_inf flags mark the identity).
// Exactly the fold_instance commitment update (nova/fold.py:100-103).
void ffec_fold_point(int cid, uint8_t *acc_xy, int *acc_inf,
                     const uint8_t *q_xy, int q_inf,
                     const uint8_t *r_le) {
  const CurveCtx &C = g_curves[cid];
  const FieldCtx &F = g_fields[C.field];
  Pt acc, q, rq;
  if (*acc_inf) {
    pt_identity(F, acc);
  } else {
    Fp x, y;
    load_le(acc_xy, x); load_le(acc_xy + 32, y);
    to_mont(F, x, acc.X); to_mont(F, y, acc.Y);
    acc.Z = F.one_mont;
  }
  u64 r[4];
  memcpy(r, r_le, 32);
  if (q_inf || (r[0] | r[1] | r[2] | r[3]) == 0) {
    pt_identity(F, rq);
  } else {
    Fp x, y;
    load_le(q_xy, x); load_le(q_xy + 32, y);
    to_mont(F, x, q.X); to_mont(F, y, q.Y);
    q.Z = F.one_mont;
    pt_scalar_mul(C, r, q, rq);
  }
  pt_add(C, acc, rq, acc);
  if (fp_is_zero(acc.Z)) {
    *acc_inf = 1;
    memset(acc_xy, 0, 64);
    return;
  }
  Fp zi, x, y;
  fp_inv(F, acc.Z, zi);
  mont_mul(F, acc.X, zi, x);
  mont_mul(F, acc.Y, zi, y);
  from_mont(F, x, x);
  from_mont(F, y, y);
  store_le(x, acc_xy);
  store_le(y, acc_xy + 32);
  *acc_inf = 0;
}

// Standalone permutation (test hook): state t*32B LE regular, in place.
void ffec_permute(int pid, uint8_t *state_le) {
  const PoseidonCtx &P = g_poseidons[pid];
  const FieldCtx &F = g_fields[P.field];
  Fp s[16];
  for (int i = 0; i < P.t; ++i) {
    Fp v; load_le(state_le + 32 * i, v);
    to_mont(F, v, s[i]);
  }
  permute(P, s);
  for (int i = 0; i < P.t; ++i) {
    Fp v; from_mont(F, s[i], v);
    store_le(v, state_le + 32 * i);
  }
}

}  // extern "C"
