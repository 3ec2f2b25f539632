"""The Pedersen keys' generator derivation on plain ints.

It imports no torch, so ops/curve.derive_generators runs it as a script in
worker processes, each on a range of indices, that start in milliseconds:
    python hash_to_curve.py NAME P B LABEL_HEX START STOP
prints the range's generators as "x y" lines of hex.

Generator i of a key is found by hash-to-x and try-and-increment: x =
SHA-512("hotproofs_tpu/gen/" || curve || "/" || label || i || ctr) mod p,
the smaller square root for y. Every index is derived on its own, so
ranges of indices can be derived in parallel and concatenated in order.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple


def sqrt_mod(a: int, p: int) -> Optional[int]:
    """Tonelli-Shanks square root mod the prime p (None for a non-residue)."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        bex = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, bex * bex % p, t * bex * bex % p, r * bex % p
    return r


def derive_range(name: str, p: int, b: int, label: bytes, start: int,
                 stop: int) -> List[Tuple[int, int]]:
    """Generators start..stop-1 of the key (curve `name`, y^2 = x^3 + b
    over F_p, `label`)."""
    prefix = b"hotproofs_tpu/gen/" + name.encode() + b"/" + label
    out: List[Tuple[int, int]] = []
    for i in range(start, stop):
        ctr = 0
        while True:
            h = hashlib.sha512(prefix + i.to_bytes(8, "little")
                               + ctr.to_bytes(4, "little")).digest()
            x = int.from_bytes(h, "little") % p
            y = sqrt_mod((x * x * x + b) % p, p)
            if y is not None:
                out.append((x, min(y, p - y)))
                break
            ctr += 1
    return out


if __name__ == "__main__":
    import sys
    name, p, b, label, start, stop = sys.argv[1:7]
    pts = derive_range(name, int(p), int(b), bytes.fromhex(label),
                       int(start), int(stop))
    sys.stdout.write("".join(f"{x:x} {y:x}\n" for x, y in pts))
