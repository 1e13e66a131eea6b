"""Hamming distance between ORB descriptors as a matmul.

The reference computes pairwise distances with the classic popcount bit hack
one descriptor pair at a time (reference: src/ORBMatcher.cc:941-956
``descDistance``).  Here the whole N×M distance matrix is one matmul:
unpack each 256-bit descriptor to a ±1 bit-sign vector, then

    dot(a, b) = 256 − 2·hamming(a, b)   ⟹   hamming = (256 − dot) / 2

which runs as a bf16 matrix product (exact: all addends are ±1
and |dot| ≤ 256 < 2^8, far inside bf16's integer-exact range... note the
*accumulator* is f32 via preferred_element_type, so the sum is exact).
"""

from __future__ import annotations

import jax.numpy as jnp

BITS = 256
WORDS = 8


def unpack_signs(desc: jnp.ndarray) -> jnp.ndarray:
    """uint32[..., 8] packed descriptors → bf16[..., 256] in {+1, −1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts) & jnp.uint32(1)  # [..., 8, 32]
    bits = bits.reshape(*desc.shape[:-1], BITS)
    return (1.0 - 2.0 * bits.astype(jnp.float32)).astype(jnp.bfloat16)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise distances int32[N, M] from packed uint32[N, 8] × uint32[M, 8]."""
    sa = unpack_signs(desc_a)
    sb = unpack_signs(desc_b)
    dot = jnp.dot(sa, sb.T, preferred_element_type=jnp.float32)
    return ((BITS - dot) * 0.5).astype(jnp.int32)


def hamming_pairs(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise distance int32[N] between aligned packed descriptor rows."""
    x = desc_a ^ desc_b
    # popcount via jax.lax.population_count on uint32 words
    import jax

    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
