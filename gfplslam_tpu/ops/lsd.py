"""Line-segment detection as a roll-only batched XLA program.

Replaces the reference's LSD wrapper (3rdparty LSDDetector_custom.cpp:218-281
around cv::LineSegmentDetector, options descriptor_custom.hpp:906-917). LSD's
sequential region-growing does not map to a data-parallel device, so
detection is re-designed around dense shifts and elementwise ops instead of
large gathers and scatters:

1. Gaussian smooth + Sobel -> gradient magnitude and angle; support mask at
   the LSD gradient threshold ``quant / sin(ang_th)`` (the same rho LSD
   derives from its options).
2. Support pixels are partitioned into 16 gradient-angle bins (8 line
   orientations x 2 gradient polarities, so the two edges of a bright ridge
   stay separate exactly as in LSD's full-circle level-line comparison).
3. Per bin: a 3x3-dilated corridor, then run-length counting along the bin's
   lattice step direction by logarithmic doubling — ``rounds`` rounds of
   pure ``jnp.roll`` (no gathers). Run ends + lengths come out as dense maps.
4. One global top-K extracts the longest run fragments; each fragment is
   sub-pixel refined by gradient-weighted perpendicular centroids at a few
   sample taps (the only gathers in the whole detector: ~40 per fragment)
   and a weighted PCA line fit.
5. Collinear fragments are merged by connected components over a dense
   [F, F] adjacency (angle / perpendicular-offset / gap gates) — this stitches
   the staircase breaks a lattice-aligned scan produces on oblique lines.
6. Gates mirroring the reference filters: relative minimum length
   (min_line_length * image diagonal, config.cpp:108), stroke width
   (density_th analog), support density, then top ``lsd_nfeatures`` by
   length (stereoFrame.cpp:1155-1227).

Output is a fixed-capacity padded segment set.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gfplslam_tpu.ops.pyramid import gaussian_blur, sobel

F_SLOTS = 1024       # fragment capacity between extraction and merging
N_SAMPLES = 8        # refinement samples along each fragment
N_PERP = 5           # perpendicular taps per sample (offsets -2..2)

# Lattice step (dx, dy) whose direction best approximates line angle
# s * 22.5 deg (x right, y down); max mismatch 4.1 deg.
STEPS = np.array([
    (1, 0), (2, 1), (1, 1), (1, 2), (0, 1), (-1, 2), (-1, 1), (-2, 1),
], dtype=np.int32)
STEP_LEN = np.sqrt((STEPS ** 2).sum(axis=1)).astype(np.float32)


class LineSegments(NamedTuple):
    sp: jax.Array      # [N, 2] float32 start point (x, y)
    ep: jax.Array      # [N, 2] float32 end point (x, y)
    angle: jax.Array   # [N] float32 orientation in (-pi, pi]
    length: jax.Array  # [N] float32
    score: jax.Array   # [N] float32 response (avg gradient magnitude)
    valid: jax.Array   # [N] bool


def _max3(x: jax.Array) -> jax.Array:
    """Separable 3x3 max via rolls (cheaper than reduce_window here)."""
    r = jnp.maximum(x, jnp.maximum(jnp.roll(x, 1, 0), jnp.roll(x, -1, 0)))
    return jnp.maximum(r, jnp.maximum(jnp.roll(r, 1, 1), jnp.roll(r, -1, 1)))


def _dilate3(m: jax.Array) -> jax.Array:
    """3x3 binary dilation (staircase tolerance for oblique runs)."""
    return _max3(m)


def _run_ends(support: jax.Array, bin16: jax.Array, rounds: int
              ) -> tuple[jax.Array, jax.Array]:
    """Dense run-length doubling over the 16 orientation/polarity bins.

    Returns (best_len_px [H, W], best_bin [H, W]): at each run-end pixel the
    longest run's pixel length and its bin; 0 elsewhere. Pure rolls — the
    doubling guard ``len == 2^r`` can never accept a wrapped source, because
    a run reaching the (zeroed) border breaks before the wrap matters.
    """
    vals = []
    for k in range(16):
        m = support & (bin16 == k)
        cor = _dilate3(m)
        dx, dy = int(STEPS[(k + 4) % 8][0]), int(STEPS[(k + 4) % 8][1])
        ln = cor.astype(jnp.int16)          # runs <= 2^rounds fit int16
        for r in range(rounds):
            step = jnp.int16(1 << r)
            behind = jnp.roll(ln, ((1 << r) * dy, (1 << r) * dx), (0, 1))
            ln = ln + jnp.where(ln == step, behind, jnp.int16(0))
        nxt = jnp.roll(cor, (-dy, -dx), (0, 1))
        endmask = cor & ~nxt
        vals.append(jnp.where(endmask, ln.astype(jnp.float32)
                              * float(STEP_LEN[(k + 4) % 8]), 0.0))
    v = jnp.stack(vals)                       # [16, H, W]
    best = jnp.max(v, axis=0)
    best_bin = jnp.argmax(v, axis=0).astype(jnp.int32)
    # 3x3 NMS with positional tie-break: the dilated corridor produces 2-3
    # parallel duplicate runs per line; keep one end pixel per neighborhood
    # so fragment slots go to distinct lines.
    hw = best.shape[0] * best.shape[1]
    enc = ((jnp.minimum(jnp.round(best * 4.0), 4000.0).astype(jnp.int32)
            * (1 << 19))
           + jnp.arange(hw, dtype=jnp.int32).reshape(best.shape) % (1 << 19))
    best = jnp.where((enc == _max3(enc)) & (best > 0), best, 0.0)
    return best, best_bin


def _refine_fragments(gx: jax.Array, gy: jax.Array, bin_ang: jax.Array,
                      start: jax.Array, end: jax.Array, rho: float):
    """Sub-pixel refinement: gradient-weighted perpendicular centroids at
    N_SAMPLES points -> weighted PCA line fit. Taps are weighted by gradient
    -angle agreement with the fragment's bin so the opposite edge of a bright
    ridge (antiparallel gradient, 2-3 px away) does not pull the centroid or
    inflate the stroke width. Takes the raw gradient components — magnitude
    and angle are computed ONLY at the ~F*S*5 tap points (a dense
    sqrt/atan2 over the full image would compute values needed at <1%% of
    pixels). Returns (center [F,2], dir [F,2] unit, sp [F,2], ep [F,2],
    width [F], density [F], wsum [F])."""
    h, w = gx.shape
    t = jnp.linspace(0.0, 1.0, N_SAMPLES)[None, :, None]     # [1, S, 1]
    pos = start[:, None, :] + t * (end - start)[:, None, :]  # [F, S, 2]
    seg = end - start
    seg_n = jnp.maximum(jnp.linalg.norm(seg, axis=1, keepdims=True), 1e-6)
    dirc = seg / seg_n                                       # [F, 2]
    nrm = jnp.stack([-dirc[:, 1], dirc[:, 0]], axis=1)       # [F, 2]
    offs = jnp.arange(-(N_PERP // 2), N_PERP // 2 + 1,
                      dtype=jnp.float32)                     # [5]
    taps = (pos[:, :, None, :]
            + offs[None, None, :, None] * nrm[:, None, None, :])  # [F,S,5,2]
    xi = jnp.clip(jnp.round(taps[..., 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(taps[..., 1]).astype(jnp.int32), 0, h - 1)
    # one two-channel gather for (gx, gy) — gathers dominate here
    g2 = jnp.stack([gx, gy], axis=-1)[yi, xi]                # [F, S, P, 2]
    mag_tap = jnp.sqrt(g2[..., 0] ** 2 + g2[..., 1] ** 2)
    ga_tap = jnp.arctan2(g2[..., 1], g2[..., 0])
    pol = jnp.maximum(jnp.cos(ga_tap - bin_ang[:, None, None]), 0.0)
    # noise floor: only support-strength taps carry weight (LSD regions only
    # contain pixels above rho; sub-threshold noise must not widen the fit)
    wts = jnp.maximum(mag_tap * pol * pol - 0.5 * rho, 0.0)  # [F, S, 5]
    wsum_s = jnp.sum(wts, axis=2)                            # [F, S]
    safe = jnp.maximum(wsum_s, 1e-6)
    perp_off = jnp.sum(wts * offs[None, None, :], axis=2) / safe
    pts = pos + perp_off[..., None] * nrm[:, None, :]        # [F, S, 2]
    # stroke width from the perpendicular second moment (uniform stroke of
    # width W has variance W^2/12)
    var_perp = jnp.maximum(
        jnp.sum(wts * offs[None, None, :] ** 2, axis=2) / safe
        - perp_off ** 2, 0.0)
    width = jnp.sqrt(12.0 * jnp.sum(var_perp * wsum_s, axis=1)
                     / jnp.maximum(jnp.sum(wsum_s, axis=1), 1e-6))
    density = jnp.mean((jnp.max(wts, axis=2) > rho).astype(jnp.float32),
                       axis=1)
    # orientation dispersion (LSD NFA-alignment analog): a straight edge has
    # near-constant gradient angle along the fragment; corner/tip arcs spread
    da = 2.0 * (ga_tap - bin_ang[:, None, None])
    wall = jnp.sum(wts, axis=(1, 2))
    rbar = jnp.sqrt(jnp.sum(wts * jnp.cos(da), (1, 2)) ** 2
                    + jnp.sum(wts * jnp.sin(da), (1, 2)) ** 2
                    ) / jnp.maximum(wall, 1e-6)
    dispersion = 1.0 - rbar
    # weighted PCA
    wsum = jnp.sum(wsum_s, axis=1)                           # [F]
    wn = wsum_s / jnp.maximum(wsum, 1e-6)[:, None]
    c = jnp.sum(wn[..., None] * pts, axis=1)                 # [F, 2]
    d = pts - c[:, None, :]
    sxx = jnp.sum(wn * d[..., 0] ** 2, axis=1)
    sxy = jnp.sum(wn * d[..., 0] * d[..., 1], axis=1)
    syy = jnp.sum(wn * d[..., 1] ** 2, axis=1)
    tr = sxx + syy
    disc = jnp.sqrt(jnp.maximum(tr * tr / 4 - (sxx * syy - sxy * sxy), 0.0))
    lam1 = tr / 2 + disc
    # principal eigenvector; when sxy ~ 0 the axes ARE the eigenvectors, so
    # pick by the larger diagonal moment (a plain 1.0 fallback silently made
    # every exactly-vertical fit horizontal)
    off_diag = jnp.abs(sxy) > 1e-9
    ex = jnp.where(off_diag, lam1 - syy, jnp.where(sxx >= syy, 1.0, 0.0))
    ey = jnp.where(off_diag, sxy, jnp.where(sxx >= syy, 0.0, 1.0))
    en = jnp.maximum(jnp.sqrt(ex * ex + ey * ey), 1e-9)
    fit = jnp.stack([ex / en, ey / en], axis=1)
    # keep the fit direction aligned with the coarse run direction
    flip = jnp.sum(fit * dirc, axis=1) < 0
    fit = jnp.where(flip[:, None], -fit, fit)
    # degenerate fits (no gradient support) fall back to the lattice direction
    fit = jnp.where((wsum > 1e-3)[:, None], fit, dirc)
    c = jnp.where((wsum > 1e-3)[:, None], c, 0.5 * (start + end))
    t_sp = jnp.sum((start - c) * fit, axis=1)
    t_ep = jnp.sum((end - c) * fit, axis=1)
    sp = c + t_sp[:, None] * fit
    ep = c + t_ep[:, None] * fit
    return c, fit, sp, ep, width, density, wsum, dispersion


def _merge_collinear(c, dirv, sp, ep, length, support_px, width, wsum, valid,
                     max_gap: float = 4.0, max_perp: float = 2.0,
                     min_cos: float = float(np.cos(np.deg2rad(12.0)))):
    """Connected components over a dense fragment-collinearity adjacency;
    returns per-ROOT merged segments (non-roots invalidated)."""
    f = c.shape[0]
    delta = c[None, :, :] - c[:, None, :]                  # [F, F, 2]
    dots = jnp.abs(jnp.sum(dirv[:, None, :] * dirv[None, :, :], axis=2))
    perp = jnp.abs(dirv[:, None, 0] * delta[..., 1]
                   - dirv[:, None, 1] * delta[..., 0])
    along = jnp.abs(jnp.sum(dirv[:, None, :] * delta, axis=2))
    gap = along - 0.5 * (length[:, None] + length[None, :])
    adj = ((dots > min_cos) & (perp < max_perp) & (gap < max_gap)
           & valid[:, None] & valid[None, :])
    adj = adj | jnp.eye(f, dtype=bool)

    lab = jnp.where(valid, jnp.arange(f, dtype=jnp.int32), f - 1)
    for _ in range(6):
        neigh = jnp.min(jnp.where(adj, lab[None, :], f), axis=1)
        lab = jnp.minimum(lab, neigh.astype(jnp.int32))
        lab = lab[lab]
        lab = lab[lab]

    dir_r = dirv[lab]
    c_r = c[lab]
    t_sp = jnp.sum((sp - c_r) * dir_r, axis=1)
    t_ep = jnp.sum((ep - c_r) * dir_r, axis=1)
    big = jnp.float32(1e9)
    t_lo = jnp.minimum(t_sp, t_ep)
    t_hi = jnp.maximum(t_sp, t_ep)
    tmin = jnp.full(f, big).at[lab].min(jnp.where(valid, t_lo, big))
    tmax = jnp.full(f, -big).at[lab].max(jnp.where(valid, t_hi, -big))
    sup = jnp.zeros(f).at[lab].add(jnp.where(valid, support_px, 0.0))
    wtot = jnp.zeros(f).at[lab].add(jnp.where(valid, wsum, 0.0))
    wid = jnp.zeros(f).at[lab].max(jnp.where(valid, width, 0.0))

    is_root = valid & (lab == jnp.arange(f))
    mlen = jnp.where(is_root, tmax - tmin, 0.0)
    msp = c + tmin[:, None] * dirv
    mep = c + tmax[:, None] * dirv
    return is_root, msp, mep, mlen, sup, wid, wtot


@partial(jax.jit, static_argnames=("n_out", "rounds", "ang_th_deg", "quant",
                                   "min_rel_length", "max_width"))
def detect_lines(img: jax.Array, n_out: int = 512, rounds: int = 9,
                 ang_th_deg: float = 22.5, quant: float = 2.0,
                 min_rel_length: float = 0.025,
                 max_width: float = 3.0) -> LineSegments:
    """[H, W] float32 image -> padded LineSegments (level-0 coordinates)."""
    h, w = img.shape
    # the fragment top-K encodes pixel position in the low 19 bits of its
    # block-reduce key (below); a larger image would silently alias
    # recovered indices to wrong pixels — fail loudly instead. EuRoC
    # (752x480 = 360960) and KITTI (1241x376 = 466616) both fit.
    if h * w >= (1 << 19):
        raise ValueError(
            f"detect_lines supports h*w < 2^19 = 524288 pixels, got "
            f"{h}x{w} = {h * w}; widen the fragment top-K key encoding "
            "(quantized length << 19 | position) for larger cameras")
    sm = gaussian_blur(img, sigma=0.8, radius=2)
    gx, gy = sobel(sm)
    # Sobel has gain 8 vs the 2x2 LSD gradient; normalize magnitude so the
    # LSD threshold rho = quant/sin(ang_th) applies on the same scale.
    gx = gx / 8.0
    gy = gy / 8.0
    ang_tol = float(np.deg2rad(ang_th_deg))
    rho = quant / np.sin(ang_tol)

    # orientation binning WITHOUT a dense atan2:
    # nearest of 16 sector centers == argmax of the dot product with the 16
    # unit vectors — one [HW, 2] @ [2, 16] matmul + argmax. The support
    # threshold compares squared magnitudes (no dense sqrt either).
    centers = np.stack([np.cos(np.arange(16) * np.pi / 8),
                        np.sin(np.arange(16) * np.pi / 8)]).astype(np.float32)
    dots = (jnp.stack([gx, gy], axis=-1).reshape(-1, 2)
            @ jnp.asarray(centers))                         # [HW, 16]
    bin16 = jnp.argmax(dots, axis=1).astype(jnp.int32).reshape(h, w)
    support = (gx * gx + gy * gy) > (rho * rho)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    support &= (yy > 1) & (yy < h - 2) & (xx > 1) & (xx < w - 2)

    best_len, best_bin = _run_ends(support, bin16, rounds)

    # --- fragment extraction: block-reduce, then top-K ---
    # top_k over the raw 360k-pixel map at k=1024 sorts every pixel; the
    # NMS'd run-end field is sparse (~10k nonzero), so keep only each
    # 2x4 block's best end first (encoded quantized-length + position key,
    # as in _run_ends' NMS) and run the top-K over the ~45k block winners.
    hp = -(-h // 2) * 2
    wp = -(-w // 4) * 4
    f = min(F_SLOTS, (hp // 2) * (wp // 4))
    enc_full = jnp.where(
        best_len > 0,
        (jnp.minimum(jnp.round(best_len * 4.0), 4000.0).astype(jnp.int32)
         * (1 << 19))
        + jnp.arange(h * w, dtype=jnp.int32).reshape(h, w) % (1 << 19),
        0)
    enc_pad = jnp.pad(enc_full, ((0, hp - h), (0, wp - w)))
    blocks = enc_pad.reshape(hp // 2, 2, wp // 4, 4).max(axis=(1, 3))
    keys, _ = jax.lax.top_k(blocks.reshape(-1), f)
    idx = keys % (1 << 19)
    # recover the un-quantized run length at the winning pixels
    vals = jnp.where(keys > 0, best_len.reshape(-1)[idx], 0.0)
    frag_ok = vals >= 3.0                       # minimum fragment extent (px)
    ex = (idx % w).astype(jnp.float32)
    ey = (idx // w).astype(jnp.float32)
    kbin = best_bin.reshape(-1)[idx]
    step = jnp.asarray(STEPS, jnp.float32)[(kbin + 4) % 8]     # [F, 2]
    slen = jnp.asarray(STEP_LEN)[(kbin + 4) % 8]
    nsteps = jnp.maximum(jnp.round(vals / slen), 1.0)
    end = jnp.stack([ex, ey], axis=1)
    start = end - (nsteps - 1.0)[:, None] * step

    bin_ang = kbin.astype(jnp.float32) * float(np.pi / 8)
    c, dirv, sp, ep, width, density, wsum, disp = _refine_fragments(
        gx, gy, bin_ang, start, end, rho)
    length = jnp.linalg.norm(ep - sp, axis=1)
    frag_ok &= jnp.isfinite(length) & (density > 0.4) & (disp < 0.25)

    is_root, msp, mep, mlen, sup, wid, wtot = _merge_collinear(
        c, dirv, sp, ep, length, vals, width, wsum, frag_ok)

    # --- gates mirroring the reference filters ---
    diag = float(np.hypot(h, w))
    ok = is_root
    ok &= mlen >= min_rel_length * diag
    ok &= wid <= max_width
    ok &= jnp.clip(sup / jnp.maximum(mlen, 1.0), 0.0, 2.0) >= 0.6
    ok &= jnp.isfinite(mlen)

    score = wtot / jnp.maximum(mlen, 1.0)
    order = jnp.argsort(jnp.where(ok, -mlen, jnp.inf))[:n_out]

    def g(a):
        out = a[order]
        if n_out > order.shape[0]:
            out = jnp.pad(out, [(0, n_out - order.shape[0])]
                          + [(0, 0)] * (out.ndim - 1))
        return out

    spx, spy = msp[:, 0], msp[:, 1]
    epx, epy = mep[:, 0], mep[:, 1]
    # canonical endpoint order: sp.x <= ep.x (ties: smaller y first)
    swap = (epx < spx) | ((epx == spx) & (epy < spy))
    spx2 = jnp.where(swap, epx, spx)
    spy2 = jnp.where(swap, epy, spy)
    epx2 = jnp.where(swap, spx, epx)
    epy2 = jnp.where(swap, spy, epy)
    angle = jnp.arctan2(epy2 - spy2, epx2 - spx2)

    return LineSegments(
        sp=jnp.stack([g(spx2), g(spy2)], -1),
        ep=jnp.stack([g(epx2), g(epy2)], -1),
        angle=g(angle), length=g(mlen), score=g(score), valid=g(ok))
