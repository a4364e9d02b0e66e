"""FAST corner detection: a fused Pallas kernel on the GPU, XLA elsewhere.

Replaces the reference's per-cell OpenCV FAST with high/low threshold fallback
(ORBextractor.cc:809-941) and the quadtree distribution ``DistributeOctTree``
(ORBextractor.cc:539-765). Design: the segment test for every pixel
at once via 16 shifted image copies and a windowed-min arc score, 3x3
non-maximum suppression, then per-cell top-k + global top-k to reproduce the
quadtree's spatial spreading with static shapes.

Score definition: ``max over the 16 circular 9-windows of min(|diff| - t)``
over fully-bright (or fully-dark) windows — positive iff the pixel passes the
FAST-9 segment test; equals the classic "max threshold still a corner" V-score
up to the arc-min approximation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Bresenham circle of radius 3, clockwise from (0,-3): (dx, dy) pairs.
FAST_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

ARC_LEN = 9  # FAST-9


def fast_score_map(img: jax.Array, threshold: jax.Array) -> jax.Array:
    """Per-pixel FAST-9 corner score (0 where not a corner). [H, W] float32.

    ``threshold`` may be a traced scalar — the adaptive-FAST loop
    (stereoFrameHandler.cpp:864-922) retunes it at runtime without recompiling.
    On an NVIDIA GPU this lowers to the fused Pallas/Triton kernel
    (:func:`fast_score_map_triton`); on any other platform to the plain XLA
    formulation (:func:`fast_score_map_xla`). The two agree bit for bit.
    """
    with jax.named_scope("fast_score"):
        return jax.lax.platform_dependent(
            img, threshold, cuda=fast_score_map_triton,
            default=fast_score_map_xla)


def fast_score_map_xla(img: jax.Array, threshold: jax.Array) -> jax.Array:
    """Plain XLA score map: the reference formulation. XLA:GPU materializes
    each rolled plane as its own concatenate kernel: 57 kernel launches per
    EuRoC frame for the 8 level images, 0.69 ms of device time on an H100
    (700 W) against 0.32 ms for the fused kernel below with its wrapper."""
    h, w = img.shape
    # bf16 margins: intensities are 0..255, so bf16's ~1-unit resolution at
    # 255 only jitters the score, not the segment test materially — and it
    # halves the dense traffic of the 16-copy stack.
    img16 = img.astype(jnp.bfloat16)
    t = jnp.asarray(threshold, jnp.bfloat16)
    # 16 shifted copies: d[k] = I(p + c_k) - I(p)
    shifted = [jnp.roll(img16, (-int(dy), -int(dx)), axis=(0, 1))
               for dx, dy in FAST_CIRCLE]
    d = jnp.stack(shifted) - img16[None]
    neg = jnp.asarray(-jnp.inf, jnp.bfloat16)
    # windowed min over 9 consecutive circle entries (circular)
    db = jnp.where(d > t, d - t, neg)            # bright margin
    dd = jnp.where(d < -t, -d - t, neg)          # dark margin
    def arc_score(x):
        xx = jnp.concatenate([x, x[:ARC_LEN - 1]], axis=0)  # circular extension
        # windowed min over 9 via shift-min doubling (1+2+4 covers 8, plus
        # the 9th element)
        m = xx
        for s in (1, 2, 4):
            m = jnp.minimum(m[:-s], m[s:])                  # covers 2s
        wmin = jnp.minimum(m[:16], xx[ARC_LEN - 1:])        # covers 9
        return jnp.max(wmin, axis=0)
    score = jnp.maximum(arc_score(db), arc_score(dd)).astype(jnp.float32)
    score = jnp.where(jnp.isfinite(score), score, 0.0)
    score = jnp.maximum(score, 0.0)
    # kill the 3px border where rolls wrap
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    valid = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(valid, score, 0.0)


# ---------------------------------------------------------------------------
# Fused FAST-9 score kernel (Pallas, Triton route). Each program computes one
# (FAST_BH, FAST_BW) output tile: 16 shifted tile loads from a 3-px padded
# bf16 image, the bright/dark margins and both windowed min/max reductions in
# registers, one store. Every bf16 operation of the XLA formulation is
# reproduced as an f32 operation rounded to bf16, so the result is
# bit-identical to fast_score_map_xla.
# ---------------------------------------------------------------------------
FAST_BH, FAST_BW = 16, 64


def _bf16_round(x: jax.Array) -> jax.Array:
    return x.astype(jnp.bfloat16).astype(jnp.float32)


def _fast_score_kernel(t_ref, x_ref, o_ref):
    i = pl.program_id(0)
    j = pl.program_id(1)
    r0 = i * FAST_BH + 3
    c0 = j * FAST_BW + 3
    t = t_ref[...].astype(jnp.float32)                    # (1, 1)
    center = x_ref[pl.ds(r0, FAST_BH),
                   pl.ds(c0, FAST_BW)].astype(jnp.float32)
    neg = jnp.float32(-jnp.inf)
    db, dd = [], []
    for dx, dy in FAST_CIRCLE:
        sh = x_ref[pl.ds(r0 + int(dy), FAST_BH),
                   pl.ds(c0 + int(dx), FAST_BW)].astype(jnp.float32)
        d = _bf16_round(sh - center)
        db.append(jnp.where(d > t, _bf16_round(d - t), neg))
        dd.append(jnp.where(d < -t, _bf16_round(-d - t), neg))

    def arc_score(x):
        # the same shift-min doubling as fast_score_map_xla, on a list
        xx = x + x[:ARC_LEN - 1]
        m = xx
        for s in (1, 2, 4):
            m = [jnp.minimum(m[k], m[k + s]) for k in range(len(m) - s)]
        out = jnp.minimum(m[0], xx[ARC_LEN - 1])
        for k in range(1, 16):
            out = jnp.maximum(out, jnp.minimum(m[k], xx[k + ARC_LEN - 1]))
        return out

    score = jnp.maximum(arc_score(db), arc_score(dd))
    score = jnp.where(score > neg, score, 0.0)
    o_ref[pl.ds(i * FAST_BH, FAST_BH), pl.ds(j * FAST_BW, FAST_BW)] = (
        jnp.maximum(score, 0.0))


def fast_score_map_triton(img: jax.Array, threshold: jax.Array,
                          interpret: bool = False) -> jax.Array:
    """FAST-9 score map as one fused Pallas kernel on the Triton route.
    Pads the image by 3 px plus up to whole tiles, crops back, and zeroes
    the 3-px border like the XLA formulation. ``interpret=True`` runs the
    kernel in the Pallas interpreter (CPU tests)."""
    h, w = img.shape
    hp = -(-h // FAST_BH) * FAST_BH
    wp = -(-w // FAST_BW) * FAST_BW
    x = jnp.pad(img.astype(jnp.bfloat16),
                ((3, hp - h + 3), (3, wp - w + 3)))
    t = jnp.asarray(threshold, jnp.bfloat16).reshape(1, 1)
    score = pl.pallas_call(
        _fast_score_kernel,
        grid=(hp // FAST_BH, wp // FAST_BW),
        out_shape=jax.ShapeDtypeStruct((hp, wp), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="fast9_score",
    )(t, x)[:h, :w]
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    valid = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(valid, score, 0.0)


def nms3(score: jax.Array) -> jax.Array:
    """3x3 non-maximum suppression; keeps strict local maxima.
    Separable roll-max; wrap contamination is confined to the border
    rows/cols, which fast_score_map already zeroed."""
    r = jnp.maximum(score,
                    jnp.maximum(jnp.roll(score, 1, 0), jnp.roll(score, -1, 0)))
    mx = jnp.maximum(r, jnp.maximum(jnp.roll(r, 1, 1), jnp.roll(r, -1, 1)))
    return jnp.where((score >= mx) & (score > 0), score, 0.0)


class Keypoints(NamedTuple):
    """Padded keypoint set for one image level (or merged levels)."""
    xy: jax.Array      # [N, 2] float32, level-0 (full-res) coordinates
    level: jax.Array   # [N] int32 pyramid octave
    score: jax.Array   # [N] float32 response
    valid: jax.Array   # [N] bool


@partial(jax.jit, static_argnames=("n_out", "cell", "per_cell", "border"))
def select_keypoints(score: jax.Array, n_out: int, cell: int = 32,
                     per_cell: int = 4, border: int = 19,
                     valid_h: jax.Array | None = None,
                     valid_w: jax.Array | None = None) -> Keypoints:
    """NMS + per-cell top-k + global top-k (quadtree-distribution equivalent,
    ORBextractor.cc:539-765). Returns exactly ``n_out`` padded keypoints in
    this level's pixel coordinates. ``valid_h``/``valid_w`` bound the live
    region when the score map is a zero-padded pyramid level."""
    h, w = score.shape
    vh = h if valid_h is None else valid_h
    vw = w if valid_w is None else valid_w
    s = nms3(score)
    # mask detector border (edge_th, config.cpp:138)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    inside = (yy >= border) & (yy < vh - border) & (xx >= border) & (xx < vw - border)
    s = jnp.where(inside, s, 0.0)
    # pad to multiples of cell
    ph = -(-h // cell) * cell
    pw = -(-w // cell) * cell
    s = jnp.pad(s, ((0, ph - h), (0, pw - w)))
    gh, gw = ph // cell, pw // cell
    cells = s.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    # per-cell top-k as k rounds of (argmax, suppress): k is tiny, so this
    # beats a row-wise top_k (which lowers to a full 1024-wide sort). The
    # suppression is a fused one-hot select.
    top_s_l, top_i_l = [], []
    work = cells
    cols = jnp.arange(cells.shape[1])[None, :]
    for _ in range(per_cell):
        i = jnp.argmax(work, axis=1)
        v = jnp.max(work, axis=1)
        top_s_l.append(v)
        top_i_l.append(i)
        work = jnp.where(cols == i[:, None], -jnp.inf, work)
    top_s = jnp.stack(top_s_l, axis=1)                     # [gh*gw, per_cell]
    top_i = jnp.stack(top_i_l, axis=1)
    # cell-local index -> global pixel coords
    ci = jnp.arange(gh * gw)[:, None]
    cy = (ci // gw) * cell + top_i // cell
    cx = (ci % gw) * cell + top_i % cell
    flat_s = top_s.reshape(-1)
    flat_y = cy.reshape(-1)
    flat_x = cx.reshape(-1)
    k = min(n_out, flat_s.shape[0])
    sel_s, sel_i = jax.lax.top_k(flat_s, k)
    pad = n_out - k
    sx = flat_x[sel_i]
    sy = flat_y[sel_i]
    # sub-pixel localization: 1D parabola fits on the (pre-NMS) score map in
    # x and y. Integer corners quantize inter-frame flow to >=1 px, which
    # destroys small-baseline motion estimates.
    def parab(sm1, s0, sp1):
        denom = sm1 - 2.0 * s0 + sp1
        off = 0.5 * (sm1 - sp1) / jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
        return jnp.clip(off, -0.5, 0.5)
    sxc = jnp.clip(sx, 1, pw - 2)
    syc = jnp.clip(sy, 1, ph - 2)
    # gather raw scores around each corner from the padded pre-NMS map
    raw = jnp.pad(score, ((0, ph - h), (0, pw - w)))
    dx_off = parab(raw[syc, sxc - 1], raw[syc, sxc], raw[syc, sxc + 1])
    dy_off = parab(raw[syc - 1, sxc], raw[syc, sxc], raw[syc + 1, sxc])
    xy = jnp.stack([sx.astype(jnp.float32) + dx_off,
                    sy.astype(jnp.float32) + dy_off], axis=-1)
    out_s = sel_s
    if pad > 0:
        xy = jnp.pad(xy, ((0, pad), (0, 0)))
        out_s = jnp.pad(out_s, (0, pad))
    return Keypoints(xy=xy, level=jnp.zeros(n_out, jnp.int32), score=out_s,
                     valid=out_s > 0)
