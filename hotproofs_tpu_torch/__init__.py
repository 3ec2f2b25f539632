"""PyTorch/CUDA port of the hotproofs_tpu prover (BLAKE3 chunk possession
proofs by Nova folding over the Pasta curves).

The JAX package `hotproofs_tpu` is the reference: this package keeps its
module names (ops/, nova/, circuits/, models/, utils/) and its number format
at every public function — field elements as (..., 32) base-2^8 digits in
int32, Montgomery form with R = 2^256 — so every module can be held against
its counterpart bit for bit. It imports torch and never jax.

The jax-free host modules of the reference (core/blake3_ref, core/native,
core/native_ff, circuits/{dsl,gadgets,blake3_compression,blake3_nova},
nova/serial) define the statement and the circuit; they are imported from
`hotproofs_tpu` directly, never copied, so both packages hash the same
circuit into the same pp digest.
"""
