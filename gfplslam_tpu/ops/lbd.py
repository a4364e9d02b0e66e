"""Line Band Descriptor (LBD-style) as a batched rotated-gather kernel.

Capability parity with the vendored binary LBD
(binary_descriptor_custom.cpp:1026+, ``computeLBD``): per-line descriptors
built from gradient statistics in bands parallel to the segment, binarized
for Hamming matching. Design:

- a fixed sample grid in line-local coordinates (S samples along x B bands
  across) is rotated per line and gathered once for all lines (vmap);
- per-band features: means and stds of the four half-wave-rectified local
  gradient components (g_perp+, g_perp-, g_par+, g_par-), matching LBD's
  band statistic structure (8 floats per band, 9 bands -> 72-dim float
  descriptor);
- binarization: 256 deterministic feature-pair comparisons -> 8 uint32
  words, so line descriptors share the popcount matching path with ORB
  (the reference's 32-byte binary LBD serves the same role).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gfplslam_tpu.ops.pyramid import sobel

N_BANDS = 9
BAND_WIDTH = 3          # rows per band across the line
N_ALONG = 12            # samples along the line (sampling budget:
                        # 9x3x12 = 324 gathered samples/line)
FLOAT_DIM = N_BANDS * 8
DESC_WORDS = 8


def _make_pair_pattern(seed: int = 77, n_bits: int = 256) -> np.ndarray:
    """[n_bits, 2] index pairs into the 72-dim float descriptor."""
    rng = np.random.default_rng(seed)
    pairs = set()
    out = []
    while len(out) < n_bits:
        i, j = rng.integers(0, FLOAT_DIM, 2)
        if i != j and (i, j) not in pairs:
            pairs.add((i, j))
            out.append((i, j))
    return np.asarray(out, np.int32)


PAIR_PATTERN = _make_pair_pattern()


def lbd_float_one(g2: jax.Array, sp: jax.Array, ep: jax.Array
                  ) -> jax.Array:
    """72-dim float band descriptor of one segment. ``g2`` is the stacked
    [H, W, 2] (gx, gy) gradient so both components come out of ONE gather."""
    h, w = g2.shape[:2]
    d = ep - sp
    length = jnp.maximum(jnp.linalg.norm(d), 1e-6)
    dir_par = d / length                       # unit along line
    dir_perp = jnp.stack([-dir_par[1], dir_par[0]])
    mid = 0.5 * (sp + ep)

    ts = (jnp.arange(N_ALONG) + 0.5) / N_ALONG - 0.5          # [-0.5, 0.5)
    half_w = N_BANDS * BAND_WIDTH / 2.0
    vs = jnp.arange(N_BANDS * BAND_WIDTH) - half_w + 0.5      # perp offsets px

    # sample grid [N_ALONG, rows, 2]
    pts = (mid[None, None, :]
           + ts[:, None, None] * length * dir_par[None, None, :]
           + vs[None, :, None] * dir_perp[None, None, :])
    xi = jnp.clip(jnp.round(pts[..., 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(pts[..., 1]).astype(jnp.int32), 0, h - 1)
    g = g2[yi, xi]
    gxs = g[..., 0]
    gys = g[..., 1]
    g_par = gxs * dir_par[0] + gys * dir_par[1]
    g_perp = gxs * dir_perp[0] + gys * dir_perp[1]

    # [4, N_ALONG, rows] rectified components
    comps = jnp.stack([jnp.maximum(g_perp, 0.0), jnp.maximum(-g_perp, 0.0),
                       jnp.maximum(g_par, 0.0), jnp.maximum(-g_par, 0.0)])
    # per band: mean + std over the band's samples
    bands = comps.reshape(4, N_ALONG, N_BANDS, BAND_WIDTH)
    mean = jnp.mean(bands, axis=(1, 3))                     # [4, N_BANDS]
    std = jnp.std(bands, axis=(1, 3))
    feat = jnp.concatenate([mean, std], axis=0)             # [8, N_BANDS]
    feat = feat.T.reshape(-1)                               # [72]
    # scale invariance: normalize like LBD (unit norm, clipped)
    feat = feat / jnp.maximum(jnp.linalg.norm(feat), 1e-6)
    return jnp.minimum(feat, 0.4)


def binarize(feat: jax.Array) -> jax.Array:
    """[72] float -> [8] uint32 via deterministic pair comparisons."""
    pat = jnp.asarray(PAIR_PATTERN)
    bits = (feat[pat[:, 0]] > feat[pat[:, 1]]).astype(jnp.uint32)
    words = bits.reshape(DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, :], axis=1, dtype=jnp.uint32)


def lbd_descriptors(img: jax.Array, sp: jax.Array, ep: jax.Array
                    ) -> tuple[jax.Array, jax.Array]:
    """[N,2] segment endpoints -> ([N, 8] uint32 binary, [N, 72] float)."""
    gx, gy = sobel(img)
    g2 = jnp.stack([gx, gy], axis=-1)
    feats = jax.vmap(lambda s, e: lbd_float_one(g2, s, e))(sp, ep)
    binary = jax.vmap(binarize)(feats)
    return binary, feats
