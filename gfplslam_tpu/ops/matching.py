"""Masked parallel match selection: mutual-best, ratio, MAD gates, budgets.

Replaces the reference's dynamic matcher post-processing — bidirectional
BFMatcher + multimap best-per-target dedup + match budgets
(stereoFrameHandler.cpp:451-695) and MAD-relative descriptor-distance gates
(stereoFrame.cpp:660-684) — with fixed-shape argmin/sort programs over a
distance matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gfplslam_tpu.ops.hamming import BIG
from gfplslam_tpu.utils.robust import masked_median, masked_stdv_mad_nozero


class Matches(NamedTuple):
    """Per-row (query) match result over a [N, M] distance matrix."""
    idx: jax.Array    # [N] int32 best column per row
    dist: jax.Array   # [N] float32 best distance
    valid: jax.Array  # [N] bool


def best2(d: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-row best index, best dist, second-best dist of [N, M]."""
    dd = d.astype(jnp.float32)
    i1 = jnp.argmin(dd, axis=1)
    d1 = jnp.min(dd, axis=1)
    # fused one-hot suppression of the best column
    masked = jnp.where(jnp.arange(d.shape[1])[None, :] == i1[:, None],
                       jnp.inf, dd)
    d2 = jnp.min(masked, axis=1)
    return i1, d1, d2


def mutual_best(d: jax.Array) -> Matches:
    """Mutual-best-match ("best_lr_matches", stereoFrame.cpp:645-658): row i
    matches col j iff argmin_j d[i, :] = j and argmin_i d[:, j] = i."""
    i1, d1, _ = best2(d)
    col_best = jnp.argmin(d.astype(jnp.float32), axis=0)   # [M]
    ok = col_best[i1] == jnp.arange(d.shape[0])
    ok &= d1 < float(BIG)
    return Matches(idx=i1, dist=d1, valid=ok)


def ratio_gate(m: Matches, d2: jax.Array, max_ratio: float) -> Matches:
    """Nearest/second-nearest ratio test (max_ratio_12_p, config.cpp:103)."""
    ok = m.valid & (m.dist < max_ratio * d2)
    return m._replace(valid=ok)


def mad_gate(m: Matches, rel_th: float) -> Matches:
    """Median + MAD relative distance gate, as the reference applies to line
    (and hybrid point) matches: keep d < median + k*mad with k derived from
    the config threshold (stereoFrameHandler.cpp:660-686 pattern)."""
    med = masked_median(m.dist, m.valid)
    mad = masked_stdv_mad_nozero(m.dist, m.valid)
    ok = m.valid & (m.dist < med + rel_th * mad)
    return m._replace(valid=ok)


def budget_gate(m: Matches, budget: int) -> Matches:
    """Budget-distance threshold + hard cap
    (max_point_match_num / max_line_match_num, config.cpp:94-95): the
    reference derives a distance bound from the K-th best match and drops
    anything above 1.2x that bound (budget_dist_th gate,
    stereoFrameHandler.cpp:658-660), then hard-breaks at K matches
    (:678-683). Here both apply on the distance-ranked set."""
    key = jnp.where(m.valid, m.dist, jnp.inf)
    order = jnp.argsort(key)
    rank = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
    kth = key[order[min(budget, key.shape[0]) - 1]]
    dist_ok = jnp.where(jnp.isfinite(kth), m.dist <= 1.2 * kth, True)
    ok = m.valid & (rank < budget) & dist_ok
    return m._replace(valid=ok)


def dedup_per_target(m: Matches, n_targets: int) -> Matches:
    """Best-per-target dedup (the multimap pass,
    stereoFrameHandler.cpp:551-599): among rows matched to the same column,
    keep the lowest-distance row."""
    key = jnp.where(m.valid, m.dist, jnp.inf)
    # min distance per target column
    best_d = jnp.full((n_targets,), jnp.inf).at[m.idx].min(key)
    # a row survives iff it attains the per-target min; break exact ties by
    # first row index
    attains = m.valid & (key <= best_d[m.idx])
    first_row = (jnp.full((n_targets,), jnp.iinfo(jnp.int32).max)
                 .at[jnp.where(attains, m.idx, n_targets - 1)]
                 .min(jnp.where(attains, jnp.arange(key.shape[0]),
                                jnp.iinfo(jnp.int32).max)))
    ok = attains & (first_row[m.idx] == jnp.arange(key.shape[0]))
    return m._replace(valid=ok)
