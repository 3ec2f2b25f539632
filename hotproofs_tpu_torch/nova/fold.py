"""NIFS: the Nova folding step (port of hotproofs_tpu/nova/fold.py).

The prover keeps the running accumulator's W, E, Az, Bz and Cz on the
device and updates them elementwise (A is linear, so Az_acc += r * Az_i);
the host keeps the running instance and folds its commitments through the
native EC helper (the port's copy of the reference's).

cross_term and fold_witness take any leading batch axes: a (K, n, 32)
accumulator folds K lockstep chains at once, with u or r as (K, 32).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..core import native_ff
from ..ops import curve as C
from ..ops import field as F
from .r1cs import ShapeDevice

Affine = Optional[Tuple[int, int]]


class AccumulatorDevice(NamedTuple):
    """Device-resident running witness state (Montgomery digits)."""

    W: torch.Tensor    # (..., n_wit, 32)
    E: torch.Tensor    # (..., n_cons, 32)
    az: torch.Tensor
    bz: torch.Tensor
    cz: torch.Tensor


@dataclass
class AccumulatorInstance:
    """Host-side running instance (group elements + scalars)."""

    u: int = 0
    X: List[int] = dc_field(default_factory=list)
    comm_W: Affine = None
    comm_E: Affine = None


def empty_accumulator(shape: ShapeDevice, batch=()) -> Tuple[
        AccumulatorDevice, AccumulatorInstance]:
    z = lambda n: F.zeros(tuple(batch) + (n,), device=shape.device)
    dev = AccumulatorDevice(W=z(shape.n_wit), E=z(shape.n_cons),
                            az=z(shape.n_cons), bz=z(shape.n_cons),
                            cz=z(shape.n_cons))
    return dev, AccumulatorInstance(u=0, X=[0] * shape.n_io)


def cross_term(spec: F.FieldSpec, acc: AccumulatorDevice, az2, bz2, cz2,
               u1_mont: torch.Tensor) -> torch.Tensor:
    """T = az1 o bz2 + az2 o bz1 - u1 * cz2 - cz1 (the step instance is
    strict, u2 = 1). u1_mont: (..., 32) with the accumulator's batch axes."""
    h = F.to_h16
    u = h(u1_mont)[..., None, :].expand(cz2.shape[:-1] + (F.N_H16,))
    m = F.h_mont_mul(spec, torch.stack([h(acc.az), h(az2), u]),
                     torch.stack([h(bz2), h(acc.bz), h(cz2)]))
    t = F.h_sub(spec, F.h_add(spec, m[0], m[1]), m[2])
    return F.from_h16(F.h_sub(spec, t, h(acc.cz)))


def fold_witness(spec: F.FieldSpec, acc: AccumulatorDevice, W2, az2, bz2,
                 cz2, T, r_mont: torch.Tensor) -> AccumulatorDevice:
    """acc + r * (W2, T, az2, bz2, cz2); r_mont: (..., 32)."""
    h = F.to_h16
    r = h(r_mont)[..., None, :]
    cons = F.h_add(spec, torch.stack([h(acc.E), h(acc.az), h(acc.bz),
                                      h(acc.cz)]),
                   F.h_mont_mul(spec, r, torch.stack([h(T), h(az2), h(bz2),
                                                      h(cz2)])))
    W = F.h_add(spec, h(acc.W), F.h_mont_mul(spec, r, h(W2)))
    E, az, bz, cz = (F.from_h16(c) for c in cons)
    return AccumulatorDevice(W=F.from_h16(W), E=E, az=az, bz=bz, cz=cz)


def fold_instance(spec: F.FieldSpec, curve: C.CurveSpec,
                  inst: AccumulatorInstance, X2: List[int], comm_W2: Affine,
                  comm_T: Affine, r: int) -> AccumulatorInstance:
    """Host-side instance fold (the verifier runs it too)."""
    p = spec.p
    if native_ff.available():
        comm_W = native_ff.fold_point(curve, inst.comm_W, comm_W2, r)
        comm_E = native_ff.fold_point(curve, inst.comm_E, comm_T, r)
    else:
        comm_W = C.host_add(curve, inst.comm_W,
                            C.host_scalar_mul(curve, r, comm_W2))
        comm_E = C.host_add(curve, inst.comm_E,
                            C.host_scalar_mul(curve, r, comm_T))
    return AccumulatorInstance(
        u=(inst.u + r) % p,
        X=[(x1 + r * x2) % p for x1, x2 in zip(inst.X, X2)],
        comm_W=comm_W, comm_E=comm_E)
