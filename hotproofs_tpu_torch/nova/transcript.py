"""Poseidon Fiat-Shamir transcript for Nova folds (port of
hotproofs_tpu/nova/transcript.py: same domain tag, absorb order and point
encoding, so both packages derive the same challenges).

Runs on the host, through the native sponge (native/ffec.cc, shared with the
reference) when it builds, else through HostSponge.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

from hotproofs_tpu.core import native_ff

from ..ops import poseidon as P

HALF_BITS = 128
HALF_MASK = (1 << HALF_BITS) - 1


class Transcript:
    def __init__(self, field_name: str, domain: bytes, pp_digest: int,
                 pspec: Optional[P.PoseidonSpec] = None):
        self.spec = pspec if pspec is not None else P.spec_for(field_name)
        tag = int.from_bytes(
            hashlib.sha256(b"hotproofs/transcript/" + domain).digest(),
            "little") % self.spec.field.p
        if native_ff.available():
            self.sponge = native_ff.NativeSponge(self.spec, domain_tag=tag)
        else:
            self.sponge = P.HostSponge(self.spec, domain_tag=tag)
        self.absorb_scalar(pp_digest)

    def absorb_scalar(self, v: int) -> None:
        self.sponge.absorb([v % self.spec.field.p])

    def absorb_scalars(self, vs: Sequence[int]) -> None:
        self.sponge.absorb([v % self.spec.field.p for v in vs])

    def absorb_point(self, pt: Optional[Tuple[int, int]]) -> None:
        """Fixed width: (x_lo, x_hi, y_lo, y_hi, infinity_flag)."""
        if pt is None:
            self.sponge.absorb([0, 0, 0, 0, 1])
        else:
            x, y = pt
            self.sponge.absorb([x & HALF_MASK, x >> HALF_BITS,
                                y & HALF_MASK, y >> HALF_BITS, 0])

    def challenge(self) -> int:
        return self.sponge.squeeze()


def transcript_poseidon_params(field_name: str) -> Tuple[int, int, int]:
    """(t, R_F, R_P) of the transcript's Poseidon instance."""
    spec = P.spec_for(field_name)
    return spec.t, spec.r_full, spec.r_partial


def digest_of(*parts: bytes) -> int:
    h = hashlib.sha256()
    for p in parts:
        h.update(hashlib.sha256(p).digest())
    return int.from_bytes(h.digest(), "little")
