"""Data-only proof serialization (JSON).

The reference serializes keys/proofs as serde plain data — JSON written for
a Solidity verifier (rust_fold/src/main.rs:337,342-346). This module is the
equivalent: proofs and checkpoints are encoded as JSON of ints/lists only,
so loading an attacker-supplied proof file can never execute code (the
pickle-based round-1 format could — a verifier must never unpickle its
input). Python's json handles arbitrary-precision ints natively; affine
points encode as [x, y] and the identity as null.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

Affine = Optional[Tuple[int, int]]

_MAGIC = "hotproofs_tpu"
_VERSION = 2


def enc_point(pt: Affine):
    return None if pt is None else [int(pt[0]), int(pt[1])]


def dec_point(obj) -> Affine:
    if obj is None:
        return None
    x, y = obj
    return (int(x), int(y))


def enc_points(pts: Sequence[Affine]):
    return [enc_point(p) for p in pts]


def dec_points(objs) -> List[Affine]:
    return [dec_point(o) for o in objs]


def enc_ints(vs) -> List[int]:
    return [int(v) for v in vs]


def dump(kind: str, payload: dict, path: str) -> None:
    doc = {"format": _MAGIC, "version": _VERSION, "kind": kind}
    doc.update(payload)
    with open(path, "w") as f:
        json.dump(doc, f)


def load(kind: str, path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("format") != _MAGIC:
        raise ValueError(f"{path}: not a {_MAGIC} file")
    if doc.get("kind") != kind:
        raise ValueError(f"{path}: kind {doc.get('kind')!r}, want {kind!r}")
    if doc.get("version") != _VERSION:
        raise ValueError(f"{path}: unsupported version {doc.get('version')}")
    return doc
