"""Image pyramid + separable filtering primitives, pure XLA.

Replaces the reference's per-level ``ComputePyramid`` + cv::resize/GaussianBlur
(ORBextractor.cc:1107-1133, binary_descriptor_custom.cpp:350-413). Levels use
the reference operating point: ``orb_nlevels=4``, scale 1.2 (config.cpp:135-137).
All levels are computed in one jitted call; each level has a static shape.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(h: int, w: int, nlevels: int, scale: float) -> List[Tuple[int, int]]:
    """Static per-level (h, w); level i is scaled by scale^-i."""
    return [(int(round(h / scale ** i)), int(round(w / scale ** i)))
            for i in range(nlevels)]


def resize_bilinear(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Bilinear resize [H, W] -> [out_h, out_w] (align-corners=False)."""
    h, w = img.shape
    ys = (jnp.arange(out_h, dtype=img.dtype) + 0.5) * (h / out_h) - 0.5
    xs = (jnp.arange(out_w, dtype=img.dtype) + 0.5) * (w / out_w) - 0.5
    y0 = jnp.clip(jnp.floor(ys), 0, h - 1)
    x0 = jnp.clip(jnp.floor(xs), 0, w - 1)
    fy = jnp.clip(ys - y0, 0.0, 1.0)
    fx = jnp.clip(xs - x0, 0.0, 1.0)
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    top = img[y0i][:, x0i] * (1 - fx)[None, :] + img[y0i][:, x1i] * fx[None, :]
    bot = img[y1i][:, x0i] * (1 - fx)[None, :] + img[y1i][:, x1i] * fx[None, :]
    return top * (1 - fy)[:, None] + bot * fy[:, None]


def build_pyramid(img: jax.Array, nlevels: int, scale: float) -> List[jax.Array]:
    """[H, W] float32 -> list of per-level images (level 0 = input)."""
    h, w = img.shape
    shapes = level_shapes(h, w, nlevels, scale)
    levels = [img]
    for (lh, lw) in shapes[1:]:
        levels.append(resize_bilinear(levels[-1], lh, lw))
    return levels


def build_pyramid_padded(img: jax.Array, nlevels: int,
                         scale: float) -> jax.Array:
    """[H, W] -> [L, H, W]: every level computed at its true resolution then
    zero-padded to the level-0 shape.

    Uniform shapes let FAST/ORB/LSD run as ONE vmapped program over
    (camera x level) instead of per-level inlined copies — the compile-size
    and batching win that motivates trading ~30% padded compute.
    """
    h, w = img.shape
    levels = build_pyramid(img, nlevels, scale)
    out = [levels[0]]
    for lv in levels[1:]:
        lh, lw = lv.shape
        out.append(jnp.pad(lv, ((0, h - lh), (0, w - lw))))
    return jnp.stack(out)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _shift(x: jax.Array, dy: int, dx: int) -> jax.Array:
    """Edge-replicated shift via pad+slice (elementwise; XLA fuses it with
    its neighbours)."""
    h, w = x.shape[-2], x.shape[-1]
    y = jnp.pad(x, [(0, 0)] * (x.ndim - 2)
                + [(max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))],
                mode="edge")
    return jax.lax.slice_in_dim(
        jax.lax.slice_in_dim(y, max(-dy, 0), max(-dy, 0) + h, axis=x.ndim - 2),
        max(-dx, 0), max(-dx, 0) + w, axis=x.ndim - 1)


from functools import lru_cache


@lru_cache(maxsize=128)
def _band_matrix(n: int, kernel: tuple) -> np.ndarray:
    """[n, n] banded matrix applying a 1D edge-replicated convolution:
    vertical pass = M @ img, horizontal pass = img @ M.T."""
    k = np.asarray(kernel, np.float64)
    r = (len(k) - 1) // 2
    m = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for t, kv in enumerate(k):
        cols = np.clip(rows + t - r, 0, n - 1)
        np.add.at(m, (rows, cols), kv)
    return m


def _separable_mxu(img: jax.Array, kv: tuple, kh: tuple) -> jax.Array:
    """Separable 2D convolution as TWO banded-matrix matmuls.

    For a 360k-px image the filter is ~0.5 GFLOP of bf16 matmul work in
    place of a shift-add chain (pad+slice per tap); whether the direct form
    is faster on the GPU is an open measurement (ROADMAP.md, Speed item 5).
    The 8-bit-intensity inputs lose nothing to bf16 operands, but the
    rounding of the result differs from a float32 shift-add. Supports
    leading batch dims ([..., H, W])."""
    h, w = img.shape[-2], img.shape[-1]
    mv = jnp.asarray(_band_matrix(h, kv), jnp.bfloat16)
    mh = jnp.asarray(_band_matrix(w, kh), jnp.bfloat16)
    y = jnp.matmul(mv, img.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    return jnp.matmul(y.astype(jnp.bfloat16), mh.T,
                      preferred_element_type=jnp.float32)


def gaussian_blur(img: jax.Array, sigma: float = 2.0, radius: int = 3) -> jax.Array:
    """Separable Gaussian blur (the 7x7 sigma-2 blur before BRIEF sampling,
    ORBextractor.cc:1043-1048) as banded-matrix matmuls."""
    k = tuple(float(x) for x in gaussian_kernel1d(sigma, radius))
    return _separable_mxu(img, k, k)


def sobel(img: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """3x3 Sobel dx, dy (gradient input for LSD/LBD; replaces cv::Sobel in
    binary_descriptor_custom.cpp:395-413). Border replicated; separable
    banded-matrix form: sobel_x = [1,2,1]^T (x) [-1,0,1]."""
    gx = _separable_mxu(img, (1.0, 2.0, 1.0), (1.0, 0.0, -1.0))
    gy = _separable_mxu(img, (1.0, 0.0, -1.0), (1.0, 2.0, 1.0))
    return gx, gy
