// Projective point arithmetic for y^2 = x^3 + b (a = 0) over field.cuh.
// Port of hotproofs_tpu/ops/pallas_curve.py: Renes-Costello-Batina 2015
// Algorithms 7 (pt_add), 8 (pt_add_mixed) and 9 (pt_double), complete
// formulas with no branch on the identity (0 : 1 : 0), plus identity,
// select and negation. The same formulas as the plain torch versions
// (ops/curve.py), so projective outputs agree bit for bit.
#pragma once

#include "field.cuh"

namespace hp {

struct Proj {
  u32 x[NW], y[NW], z[NW];
};

struct Aff {
  u32 x[NW], y[NW];
};

HP_HD void pt_identity(const Consts& c, Proj& r) {
  fe_zero(r.x);
  fe_copy(r.y, c.one);
  fe_zero(r.z);
}

// r = p + q (Algorithm 7). r may alias p or q.
HP_HD void pt_add(const Consts& c, const Proj& p, const Proj& q, Proj& r) {
  u32 t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], u[NW], v[NW];
  u32 X3[NW], Y3[NW], Z3[NW];
  mont_mul(c, p.x, q.x, t0);
  mont_mul(c, p.y, q.y, t1);
  mont_mul(c, p.z, q.z, t2);
  fe_add(c, p.x, p.y, u);
  fe_add(c, q.x, q.y, v);
  mont_mul(c, u, v, t3);
  fe_add(c, t0, t1, u);
  fe_sub(c, t3, u, t3);
  fe_add(c, p.y, p.z, u);
  fe_add(c, q.y, q.z, v);
  mont_mul(c, u, v, t4);
  fe_add(c, t1, t2, u);
  fe_sub(c, t4, u, t4);
  fe_add(c, p.x, p.z, u);
  fe_add(c, q.x, q.z, v);
  mont_mul(c, u, v, Y3);
  fe_add(c, t0, t2, u);
  fe_sub(c, Y3, u, Y3);
  fe_add(c, t0, t0, X3);
  fe_add(c, X3, t0, t0);
  mont_mul(c, c.b3, t2, t2);
  fe_add(c, t1, t2, Z3);
  fe_sub(c, t1, t2, t1);
  mont_mul(c, c.b3, Y3, Y3);
  mont_mul(c, t4, Y3, X3);
  mont_mul(c, t3, t1, u);
  fe_sub(c, u, X3, X3);
  mont_mul(c, t1, Z3, u);
  mont_mul(c, Y3, t0, v);
  fe_add(c, u, v, Y3);
  mont_mul(c, Z3, t4, u);
  mont_mul(c, t0, t3, v);
  fe_add(c, u, v, Z3);
  fe_copy(r.x, X3);
  fe_copy(r.y, Y3);
  fe_copy(r.z, Z3);
}

// r = p + q for an affine q that is never the identity (Algorithm 8).
HP_HD void pt_add_mixed(const Consts& c, const Proj& p, const Aff& q,
                        Proj& r) {
  u32 t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], u[NW];
  u32 X3[NW], Y3[NW], Z3[NW];
  mont_mul(c, p.x, q.x, t0);
  mont_mul(c, p.y, q.y, t1);
  fe_add(c, q.x, q.y, t3);
  fe_add(c, p.x, p.y, t4);
  mont_mul(c, t3, t4, t3);
  fe_add(c, t0, t1, t4);
  fe_sub(c, t3, t4, t3);
  mont_mul(c, q.y, p.z, t4);
  fe_add(c, t4, p.y, t4);
  mont_mul(c, q.x, p.z, Y3);
  fe_add(c, Y3, p.x, Y3);
  fe_add(c, t0, t0, X3);
  fe_add(c, X3, t0, t0);
  mont_mul(c, c.b3, p.z, t2);
  fe_add(c, t1, t2, Z3);
  fe_sub(c, t1, t2, t1);
  mont_mul(c, c.b3, Y3, Y3);
  mont_mul(c, t4, Y3, X3);
  mont_mul(c, t3, t1, u);
  fe_sub(c, u, X3, X3);
  mont_mul(c, Y3, t0, u);
  mont_mul(c, t1, Z3, t1);
  fe_add(c, t1, u, Y3);
  mont_mul(c, t0, t3, u);
  mont_mul(c, Z3, t4, Z3);
  fe_add(c, Z3, u, Z3);
  fe_copy(r.x, X3);
  fe_copy(r.y, Y3);
  fe_copy(r.z, Z3);
}

// r = 2p (Algorithm 9). r may alias p.
HP_HD void pt_double(const Consts& c, const Proj& p, Proj& r) {
  u32 t0[NW], t1[NW], t2[NW], X3[NW], Y3[NW], Z3[NW];
  mont_mul(c, p.y, p.y, t0);
  fe_add(c, t0, t0, Z3);
  fe_add(c, Z3, Z3, Z3);
  fe_add(c, Z3, Z3, Z3);
  mont_mul(c, p.y, p.z, t1);
  mont_mul(c, p.z, p.z, t2);
  mont_mul(c, c.b3, t2, t2);
  mont_mul(c, t2, Z3, X3);
  fe_add(c, t0, t2, Y3);
  mont_mul(c, t1, Z3, Z3);
  fe_add(c, t2, t2, t1);
  fe_add(c, t1, t2, t2);
  fe_sub(c, t0, t2, t0);
  mont_mul(c, t0, Y3, Y3);
  fe_add(c, X3, Y3, Y3);
  mont_mul(c, p.x, p.y, t1);
  mont_mul(c, t0, t1, X3);
  fe_add(c, X3, X3, X3);
  fe_copy(r.x, X3);
  fe_copy(r.y, Y3);
  fe_copy(r.z, Z3);
}

HP_HD void pt_neg(const Consts& c, const Proj& p, Proj& r) {
  u32 zero[NW];
  fe_zero(zero);
  fe_copy(r.x, p.x);
  fe_sub(c, zero, p.y, r.y);
  fe_copy(r.z, p.z);
}

HP_HD void pt_select(bool cond, const Proj& a, const Proj& b, Proj& r) {
  r = cond ? a : b;
}

}  // namespace hp
