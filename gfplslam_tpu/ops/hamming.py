"""Batched Hamming-distance matrices for binary descriptors.

The reference computes Hamming distances pairwise inside BFMatcher loops and a
hand-rolled popcount (stereoFrame.h:185-201). Here the whole N x M distance
matrix is one XLA expression: XOR-broadcast + ``lax.population_count`` + sum,
which XLA fuses into one reduction and, where it can, into the consumer
(argmin, mutual-best) as well.

Descriptors: [N, W] uint32 (W=8 words = 256 bits). Invalid rows are masked by
setting their distances to ``BIG``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BIG = jnp.uint32(1 << 16)  # > max possible distance (256)


def hamming_matrix(a: jax.Array, b: jax.Array,
                   valid_a: jax.Array | None = None,
                   valid_b: jax.Array | None = None) -> jax.Array:
    """[N, W] x [M, W] uint32 -> [N, M] uint32 Hamming distances; invalid
    rows/cols get BIG."""
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    d = jnp.sum(jax.lax.population_count(x), axis=-1, dtype=jnp.uint32)
    if valid_a is not None:
        d = jnp.where(valid_a[:, None], d, BIG)
    if valid_b is not None:
        d = jnp.where(valid_b[None, :], d, BIG)
    return d
