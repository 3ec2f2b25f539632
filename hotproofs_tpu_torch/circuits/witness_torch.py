"""Batched BLAKE3 Nova-step witness generation in plain torch (port of
hotproofs_tpu/circuits/witness_jax.py).

Computes whole witness matrices for batches of steps as vector ops: bit
decompositions, u32 adds with their carries, word XORs and the step's
control flags, emitted in the DSL's allocation order signal for signal.
u32 words are held in int64 and masked, since torch's uint32 lacks the
shifts this needs. The three IsZero inverse hints get a placeholder 0; the
caller patches them (nova_big_positions / nova_inverse_values, shared with
the reference) when it expands signals to field digits.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from hotproofs_tpu.circuits.blake3_compression import (G_SCHEDULE, R1, R2,
                                                       R3, R4, VESTA_PRIME)
from hotproofs_tpu.circuits.blake3_nova import get_nova_step_circuit
from hotproofs_tpu.core.blake3_ref import IV, MSG_PERMUTATION

MASK32 = 0xFFFFFFFF


@lru_cache(maxsize=None)
def nova_big_positions(modulus: int = VESTA_PRIME,
                       depth_bits: int = 8) -> np.ndarray:
    """Signal indices of the three full-width IsZero inverse hints."""
    _, layout = get_nova_step_circuit(modulus, 0, depth_bits)
    idx = [seg.start for seg in layout.segments
           if seg.role == "aux" and seg.name.endswith("/inv")]
    assert len(idx) == 3
    return np.asarray(idx, np.int64)


def nova_inverse_values(depth: int, block_count: int, n_blocks: int,
                        modulus: int = VESTA_PRIME) -> List[int]:
    """The three inverse hints of one step (functions of the public
    schedule): 1/depth, 1/block_count, 1/(block_count - (n_blocks - 1)),
    each 0 where the value is 0."""
    def inv(v):
        v %= modulus
        return pow(v, modulus - 2, modulus) if v else 0

    return [inv(depth), inv(block_count), inv(block_count - (n_blocks - 1))]


def _decomp(w: torch.Tensor, n: int = 32) -> torch.Tensor:
    """(B,) words -> (B, n) bits, LSB first."""
    return (w[..., None] >> torch.arange(n, device=w.device)) & 1


def _rotr(w: torch.Tensor, r: int) -> torch.Tensor:
    return ((w >> r) | (w << (32 - r))) & MASK32


def _add_with_carry(*terms: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(low 32 bits, bits 32+) of the exact sum of u32 terms."""
    s = terms[0]
    for t in terms[1:]:
        s = s + t
    return s & MASK32, s >> 32


class _Emitter:
    def __init__(self):
        self.aux: List[torch.Tensor] = []

    def bits(self, w, n=32):
        self.aux.append(_decomp(w, n))

    def split2(self, low, carry):  # 32 bits + 2 carry bits
        self.aux.append(torch.cat([_decomp(low, 32), _decomp(carry, 2)], 1))

    def split1(self, low, carry):  # 32 bits + 1 carry bit
        self.aux.append(torch.cat([_decomp(low, 32), carry[:, None]], 1))

    def one(self, v):
        self.aux.append(v[:, None])


def _compression_core(em: _Emitter, h_words, m_words, t0, t1, b, d):
    """Emit the compression gadget's aux signals; returns the 16 output
    words (blake3_compression.compression_gadget order)."""
    B = t0.shape[0]
    for w in (t0, t1, b, d):
        em.bits(w)
    full = lambda v: torch.full((B,), v, dtype=torch.int64, device=t0.device)
    state = list(h_words) + [full(IV[i]) for i in range(4)] + [t0, t1, b, d]
    msg = list(m_words)
    for rnd in range(7):
        for gi, (ia, ib, ic, id_) in enumerate(G_SCHEDULE):
            va, vb, vc, vd = state[ia], state[ib], state[ic], state[id_]
            mx, my = msg[2 * gi], msg[2 * gi + 1]
            va, carry = _add_with_carry(va, vb, mx)
            em.split2(va, carry)
            x = vd ^ va
            em.bits(x)
            vd = _rotr(x, R1)
            vc, carry = _add_with_carry(vc, vd)
            em.split1(vc, carry)
            x = vb ^ vc
            em.bits(x)
            vb = _rotr(x, R2)
            va, carry = _add_with_carry(va, vb, my)
            em.split2(va, carry)
            x = vd ^ va
            em.bits(x)
            vd = _rotr(x, R3)
            vc, carry = _add_with_carry(vc, vd)
            em.split1(vc, carry)
            x = vb ^ vc
            em.bits(x)
            vb = _rotr(x, R4)
            state[ia], state[ib], state[ic], state[id_] = va, vb, vc, vd
        if rnd < 6:
            msg = [msg[p] for p in MSG_PERMUTATION]
    out_words = []
    for i in range(8):
        out_words.append(state[i] ^ state[i + 8])
        em.bits(out_words[-1])
    for i in range(8, 16):
        out_words.append(state[i] ^ h_words[i - 8])
        em.bits(out_words[-1])
    return out_words


def batched_nova_witness(z_in: torch.Tensor, m: torch.Tensor,
                         b: torch.Tensor, down_left: torch.Tensor,
                         d_flags: int = 0,
                         depth_bits: int = 8) -> torch.Tensor:
    """Witness matrix (B, n_signals) int64 (each < 2^32) for the Nova step.

    z_in (B, 15), m (B, 16), b and down_left (B,): u32 values in int64."""
    z_in, m = z_in.to(torch.int64), m.to(torch.int64)
    b, down_left = b.to(torch.int64), down_left.to(torch.int64)
    B = z_in.shape[0]
    zero = torch.zeros((B,), dtype=torch.int64, device=z_in.device)
    em = _Emitter()

    n_blocks, block_count = z_in[:, 0], z_in[:, 1]
    h_w = [z_in[:, 2 + i] for i in range(8)]
    total_depth, depth = z_in[:, 10], z_in[:, 11]
    cil, cih = z_in[:, 12], z_in[:, 13]
    leaf_depth = z_in[:, 14]

    # depth_check scope.
    two_pow_d = 1 << depth_bits
    em.bits(depth, depth_bits)
    em.bits(leaf_depth, depth_bits)
    is_root = (depth == 0).to(torch.int64)
    em.one(zero)                      # inv placeholder (is_zero(depth))
    em.one(is_root)
    ltv = (depth + two_pow_d - (leaf_depth - 1)) & MASK32
    em.bits(ltv, depth_bits + 1)
    is_parent = 1 - ((ltv >> depth_bits) & 1)
    ltv2 = (depth + two_pow_d - leaf_depth) & MASK32
    em.bits(ltv2, depth_bits + 1)

    # flags scope.
    not_parent = 1 - is_parent
    eq_first = (block_count == 0).to(torch.int64)
    em.one(zero)                      # inv placeholder (is_zero(block_count))
    em.one(eq_first)
    eq_last = (block_count == ((n_blocks - 1) & MASK32)).to(torch.int64)
    em.one(zero)                      # inv placeholder
    em.one(eq_last)
    first_set = eq_first * not_parent
    em.one(first_set)
    is_last_block = eq_last * not_parent
    em.one(is_last_block)
    par_and_last = is_parent * eq_last
    em.one(par_and_last)
    use_root = (is_parent + eq_last - par_and_last) * is_root
    em.one(use_root)
    d_word = (d_flags + first_set + 2 * is_last_block + 8 * use_root
              + 4 * is_parent)

    # h_bits scope.
    for i in range(8):
        em.bits(h_w[i])

    # message scope.
    parent = is_parent.bool()
    dl = torch.where(parent, down_left, torch.ones_like(down_left))
    em.one(dl)
    dlb = dl.bool()
    m_eff = []
    for i in range(8):
        pl = torch.where(dlb, h_w[i], m[:, i])
        em.one(pl)
        me = torch.where(parent, pl, m[:, i])
        em.one(me)
        m_eff.append(me)
    for i in range(8, 16):
        pr = torch.where(dlb, m[:, i - 8], h_w[i - 8])
        em.one(pr)
        me = torch.where(parent, pr, m[:, i])
        em.one(me)
        m_eff.append(me)

    # h_comp scope: the 32 mux outputs ARE the bits of hc.
    h_comp = []
    for i in range(8):
        hc = torch.where(parent, torch.full_like(h_w[i], IV[i]), h_w[i])
        em.bits(hc)
        h_comp.append(hc)

    # t scope.
    t0 = cil * not_parent
    em.one(t0)
    t1 = cih * not_parent
    em.one(t1)

    out_words = _compression_core(em, h_comp, m_eff, t0, t1, b, d_word)

    # update scope.
    decr = (is_last_block + is_parent) * (1 - is_root)
    em.one(decr)

    z_out = torch.stack(
        [n_blocks, block_count + not_parent] + out_words[:8]
        + [total_depth, (depth - decr) & MASK32, cil, cih, leaf_depth], 1)
    header = torch.cat([torch.ones((B, 1), dtype=torch.int64,
                                   device=z_in.device), z_out, z_in, m,
                        b[:, None], down_left[:, None]], 1)
    return torch.cat([header] + em.aux, 1)


def witness_canon(w_u32: torch.Tensor, big_pos, inv_values) -> torch.Tensor:
    """(B, n_signals) u32 signals -> (B, n_signals, 32) canonical field
    digits, with the full-width inverse hints patched in.

    inv_values: (B, len(big_pos), 32) int32 digits of the hints."""
    B, n = w_u32.shape
    canon = torch.zeros((B, n, 32), dtype=torch.int32, device=w_u32.device)
    for k in range(4):
        canon[..., k] = ((w_u32 >> (8 * k)) & 0xFF).to(torch.int32)
    idx = torch.as_tensor(big_pos, dtype=torch.int64, device=w_u32.device)
    canon[:, idx] = inv_values.to(w_u32.device)
    return canon
