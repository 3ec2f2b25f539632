"""Parsers for circom build artifacts: .sym, .wtns and .r1cs.

Capability replacement for circom-scotia's binary-format layer
(SURVEY.md §2b: circom-scotia 0.2.0 parses .r1cs and drives the wasm
witness calculator, rust_fold/src/blake3_circuit.rs:305) and for the
snarkjs .wtns files the reference checks in
(build/blake3_compression/testInp/witness.wtns).  The TPU stack builds its
own constraint systems from the DSL, so these parsers exist for *parity*:
they let tests read foreign artifacts (the reference's 69,380-signal .sym
and its recorded witness) and check our oracle/circuit semantics against
the reference's actual recorded circuit execution — the only ground truth
available for signal-level behavior (the .r1cs blobs are stripped from the
mount, .MISSING_LARGE_BLOBS:1-8, so the R1CS reader is validated
structurally on synthetic bytes).

Formats (iden3 binary container spec shared by .wtns/.r1cs):
    magic(4) version(u32 LE) n_sections(u32 LE)
    then per section: id(u32) length(u64) payload
.wtns sections: 1 = header (n8, prime, n_witness), 2 = values (n8 LE each).
.r1cs sections: 1 = header (n8, prime, n_wires, n_pub_out, n_pub_in,
    n_prv_in, n_labels u64, n_constraints), 2 = constraints (three linear
    combinations per constraint, each: n_terms u32 then (wire u32,
    coeff n8-bytes LE) pairs), 3 = wire-to-label map (u64 per wire).
.sym: text lines  signal_idx,witness_idx,component_idx,qualified_name
    (witness_idx == -1 when the optimizer eliminated the signal).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class SymEntry:
    signal_idx: int
    witness_idx: int   # -1 if optimized out of the witness
    component_idx: int
    name: str


@dataclass
class SymTable:
    entries: List[SymEntry]

    def __post_init__(self):
        self.by_name: Dict[str, SymEntry] = {
            e.name: e for e in self.entries}

    @property
    def n_signals(self) -> int:
        return max(e.signal_idx for e in self.entries) if self.entries else 0

    def witness_index(self, name: str) -> int:
        e = self.by_name[name]
        if e.witness_idx < 0:
            raise KeyError(f"{name}: optimized out of the witness")
        return e.witness_idx


def parse_sym(path: str) -> SymTable:
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            s, w, c, name = line.split(",", 3)
            entries.append(SymEntry(int(s), int(w), int(c), name))
    return SymTable(entries)


# ---------------------------------------------------------------------------
# Shared iden3 binary container.
# ---------------------------------------------------------------------------


def _read_container(data: bytes, magic: bytes) -> Dict[int, bytes]:
    if data[:4] != magic:
        raise ValueError(f"bad magic {data[:4]!r}, want {magic!r}")
    version, n_sections = struct.unpack_from("<II", data, 4)
    if version not in (1, 2):
        raise ValueError(f"unsupported {magic.decode()} version {version}")
    sections: Dict[int, bytes] = {}
    off = 12
    for _ in range(n_sections):
        if off + 12 > len(data):
            raise ValueError("truncated section header")
        sid, slen = struct.unpack_from("<IQ", data, off)
        off += 12
        if off + slen > len(data):
            raise ValueError(f"truncated section {sid}")
        sections[sid] = data[off: off + slen]
        off += slen
    return sections


@dataclass
class Witness:
    prime: int
    values: List[int]

    def __len__(self) -> int:
        return len(self.values)


def parse_wtns(path: str) -> Witness:
    with open(path, "rb") as f:
        data = f.read()
    sections = _read_container(data, b"wtns")
    hdr = sections[1]
    n8, = struct.unpack_from("<I", hdr, 0)
    prime = int.from_bytes(hdr[4: 4 + n8], "little")
    n_wit, = struct.unpack_from("<I", hdr, 4 + n8)
    body = sections[2]
    if len(body) != n8 * n_wit:
        raise ValueError(
            f"witness body is {len(body)} bytes, want {n8 * n_wit}")
    values = [int.from_bytes(body[i * n8: (i + 1) * n8], "little")
              for i in range(n_wit)]
    return Witness(prime=prime, values=values)


LC = List[Tuple[int, int]]  # (wire index, coefficient)


@dataclass
class R1CS:
    prime: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    constraints: List[Tuple[LC, LC, LC]]
    wire_to_label: Optional[List[int]] = None


def parse_r1cs(path: str) -> R1CS:
    with open(path, "rb") as f:
        data = f.read()
    sections = _read_container(data, b"r1cs")
    hdr = sections[1]
    n8, = struct.unpack_from("<I", hdr, 0)
    prime = int.from_bytes(hdr[4: 4 + n8], "little")
    (n_wires, n_pub_out, n_pub_in, n_prv_in) = struct.unpack_from(
        "<IIII", hdr, 4 + n8)
    n_labels, = struct.unpack_from("<Q", hdr, 20 + n8)
    n_cons, = struct.unpack_from("<I", hdr, 28 + n8)

    body = sections[2]
    off = 0
    constraints: List[Tuple[LC, LC, LC]] = []

    def read_lc() -> LC:
        nonlocal off
        n_terms, = struct.unpack_from("<I", body, off)
        off += 4
        terms = []
        for _ in range(n_terms):
            wire, = struct.unpack_from("<I", body, off)
            coeff = int.from_bytes(body[off + 4: off + 4 + n8], "little")
            off += 4 + n8
            terms.append((wire, coeff))
        return terms

    for _ in range(n_cons):
        constraints.append((read_lc(), read_lc(), read_lc()))
    if off != len(body):
        raise ValueError("trailing bytes after constraints section")

    wire_to_label = None
    if 3 in sections:
        lab = sections[3]
        wire_to_label = [v for (v,) in struct.iter_unpack("<Q", lab)]

    return R1CS(prime=prime, n_wires=n_wires, n_pub_out=n_pub_out,
                n_pub_in=n_pub_in, n_prv_in=n_prv_in, n_labels=n_labels,
                constraints=constraints, wire_to_label=wire_to_label)


def write_r1cs(path: str, r: R1CS, n8: int = 32) -> None:
    """Emit a spec-conformant .r1cs (round-trip tests; the reference's
    blobs are stripped so synthetic bytes are the only structural check)."""
    hdr = struct.pack("<I", n8) + r.prime.to_bytes(n8, "little")
    hdr += struct.pack("<IIIIQI", r.n_wires, r.n_pub_out, r.n_pub_in,
                       r.n_prv_in, r.n_labels, len(r.constraints))
    body = b""
    for (a, b, c) in r.constraints:
        for lc in (a, b, c):
            body += struct.pack("<I", len(lc))
            for wire, coeff in lc:
                body += struct.pack("<I", wire)
                body += (coeff % r.prime).to_bytes(n8, "little")
    out = b"r1cs" + struct.pack("<II", 1, 2 if r.wire_to_label is None
                                else 3)
    out += struct.pack("<IQ", 1, len(hdr)) + hdr
    out += struct.pack("<IQ", 2, len(body)) + body
    if r.wire_to_label is not None:
        lab = b"".join(struct.pack("<Q", v) for v in r.wire_to_label)
        out += struct.pack("<IQ", 3, len(lab)) + lab
    with open(path, "wb") as f:
        f.write(out)
