"""Standalone verification key: export and import (port of
hotproofs_tpu/nova/vk.py; the same JSON document, byte for byte).

`export_vk` writes what a verifier needs and nothing of the prover:
  * the R1CS shape as COO triples with canonical-int values;
  * the commitment key as (label, n): the generators are derived again by
    hash-to-curve (ops/curve.derive_generators), so the vk stays small;
  * the transcript's Poseidon parameters (t, R_F, R_P);
  * the pp digest, which `ivc_from_vk` recomputes from the rebuilt shape,
    key and sponge and holds against the vk's claim, so a changed vk
    cannot point a proof at another circuit.
`ivc_from_vk` builds a verifier-capable IVC on `device` without compiling
the circuit DSL.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops import curve as C
from ..ops import field as F
from ..ops import poseidon as P
from ..utils.config import require_device
from . import serial
from .ivc import IVC, check
from .pedersen import CommitmentKey
from .r1cs import ShapeDevice, SparseMat, _mat_from_coo
from .transcript import transcript_poseidon_params


def _mat_to_dict(spec: F.FieldSpec, m: SparseMat) -> dict:
    """The matrix's COO entries in their stored (row-sorted) order, values
    as canonical ints."""
    rinv = pow(spec.r_mod_p, spec.p - 2, spec.p)
    return {
        "rows": [int(r) for r in m.rows],
        "cols": [int(c) for c in m.cols],
        "vals": [F.limbs_to_int(v) * rinv % spec.p for v in m.vals_mont],
    }


def export_vk(ivc: IVC, path: str, statement: str = "blake3-chunk",
              io_arity: Optional[int] = None) -> None:
    shape = ivc.shape
    if ivc.pspec is not None:
        t, r_full, r_partial = (ivc.pspec.t, ivc.pspec.r_full,
                                ivc.pspec.r_partial)
    else:
        t, r_full, r_partial = transcript_poseidon_params(shape.field.name)
    serial.dump("verification_key", {
        "curve": ivc.curve.name,
        "field": shape.field.name,
        "label": ivc.label.decode(),
        "ck_label": ivc.ck.label.decode(),
        "ck_n": int(ivc.ck.n),
        "n_cons": int(shape.n_cons),
        "n_vars": int(shape.n_vars),
        "n_io": int(shape.n_io),
        "A": _mat_to_dict(shape.field, shape.A),
        "B": _mat_to_dict(shape.field, shape.B),
        "C": _mat_to_dict(shape.field, shape.C),
        "poseidon": {"t": t, "r_full": r_full, "r_partial": r_partial},
        "pp_digest": int(ivc.pp_digest),
        "statement": statement,
        "io_arity": int(io_arity) if io_arity is not None else None,
    }, path)


def ivc_from_vk(path: str, device="cuda") -> IVC:
    """A verifier-capable IVC on `device` from a vk document. Raises
    AssertionError on a malformed vk, a sponge below the security bound,
    or a recomputed pp digest that differs from the vk's claim."""
    dev = require_device(device)
    d = serial.load("verification_key", path)
    curve = C.CURVES[d["curve"]]
    spec = F.FIELDS[d["field"]]
    check(curve.scalar.p == spec.p, "vk curve/field mismatch")
    n_cons, n_vars = int(d["n_cons"]), int(d["n_vars"])
    mats = []
    for k in ("A", "B", "C"):
        md = d[k]
        rows = np.asarray([int(v) for v in md["rows"]], np.int64)
        cols = np.asarray([int(v) for v in md["cols"]], np.int64)
        vals = np.asarray([int(v) % spec.p for v in md["vals"]],
                          dtype=object)
        check(len(rows) == len(cols) == len(vals), "vk matrix ragged")
        check(rows.size == 0 or (0 <= rows.min() and rows.max() < n_cons),
              "vk row range")
        check(cols.size == 0 or (0 <= cols.min() and cols.max() < n_vars),
              "vk col range")
        mats.append(_mat_from_coo(spec, rows, cols, vals, n_cons))
    shape = ShapeDevice(spec, n_cons, n_vars, int(d["n_io"]), *mats,
                        device=dev)
    # The vk's sponge is adopted, not the process's HOTPROOFS_POSEIDON
    # choice: (t, R_F, R_P) alone fixes the round constants, so it fixes
    # the transcript. It is checked before anything is built from it: t
    # in range (the native sponge's registry takes t <= 16), and rounds no
    # fewer than neptune's search gives for this width, so a vk cannot
    # weaken the permutation. The pp digest binds (t, R_F, R_P) as well.
    pd = d["poseidon"]
    t, r_full, r_partial = (int(pd["t"]), int(pd["r_full"]),
                            int(pd["r_partial"]))
    check(2 <= t <= 16, f"vk poseidon t={t} out of range [2,16]")
    rf_min, rp_min = P.neptune_round_numbers(t, n_bits=255)
    check(r_full >= rf_min and r_partial >= rp_min,
          f"vk poseidon rounds ({r_full},{r_partial}) below the security "
          f"lower bound ({rf_min},{rp_min}) for t={t}")
    pspec = P.make_spec(spec.name, t=t, r_full=r_full, r_partial=r_partial)
    ck = CommitmentKey.create(curve, d["ck_label"].encode(), int(d["ck_n"]),
                              dev)
    ivc = IVC(shape, curve, ck, big_wit_idx=None,
              label=d["label"].encode(), pspec=pspec)
    check(ivc.pp_digest == int(d["pp_digest"]),
          "vk pp digest mismatch (tampered or stale vk)")
    return ivc
