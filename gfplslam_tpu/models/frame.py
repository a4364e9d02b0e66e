"""Per-frame stereo front-end: detection, stereo matching, triangulation.

Capability parity with ``StereoFrame`` (stereoFrame.cpp): feature detection
(:1019-1227), ORB-SLAM-style point stereo matching with sub-pixel refinement
(:411-630, :340-404), line stereo matching with disparity-from-line-
intersection and overlap/horizontality/covariance gates (:632-767), and the
per-endpoint 3D covariance model (:1375-1484).

Design: the reference's 4 detection threads + per-feature loops
become a handful of batched device programs over fixed-capacity padded
arrays; L/R images are processed by the same vmapped kernels; candidate
search loops become masked distance matrices.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from gfplslam_tpu.config import Config, CameraParams
from gfplslam_tpu.ops import fast as fast_ops
from gfplslam_tpu.ops import lbd as lbd_ops
from gfplslam_tpu.ops import lsd as lsd_ops
from gfplslam_tpu.ops import orb as orb_ops
from gfplslam_tpu.ops import camera as cam_ops
from gfplslam_tpu.ops.hamming import hamming_matrix
from gfplslam_tpu.ops.matching import mutual_best
from gfplslam_tpu.ops.pyramid import (build_pyramid_padded, gaussian_blur,
                                      level_shapes)
from gfplslam_tpu.utils.robust import masked_median, masked_stdv_mad_nozero


class CameraFeatures(NamedTuple):
    """Detected features of one camera image (padded)."""
    pt_xy: jax.Array      # [Np, 2] level-0 pixel coords
    pt_level: jax.Array   # [Np] int32 octave
    pt_angle: jax.Array   # [Np] float32
    pt_desc: jax.Array    # [Np, 8] uint32
    pt_score: jax.Array   # [Np]
    pt_valid: jax.Array   # [Np] bool
    ln_sp: jax.Array      # [Nl, 2]
    ln_ep: jax.Array      # [Nl, 2]
    ln_angle: jax.Array   # [Nl]
    ln_desc: jax.Array    # [Nl, 8] uint32
    ln_valid: jax.Array   # [Nl] bool


class StereoPoints(NamedTuple):
    """Triangulated stereo point features (left-anchored;
    stereoFeatures.h:51-61)."""
    xy: jax.Array       # [Np, 2] left pixel
    disp: jax.Array     # [Np]
    p3d: jax.Array      # [Np, 3]
    desc: jax.Array     # [Np, 8] uint32
    level: jax.Array    # [Np]
    sigma2: jax.Array   # [Np]
    valid: jax.Array    # [Np] bool


class StereoLines(NamedTuple):
    """Triangulated stereo line features (stereoFeatures.h:96-129)."""
    sp: jax.Array       # [Nl, 2] left start point
    ep: jax.Array       # [Nl, 2]
    sdisp: jax.Array    # [Nl]
    edisp: jax.Array    # [Nl]
    sp3d: jax.Array     # [Nl, 3]
    ep3d: jax.Array     # [Nl, 3]
    le: jax.Array       # [Nl, 3] normalized 2D line coefficients (left)
    angle: jax.Array    # [Nl]
    desc: jax.Array     # [Nl, 8] uint32
    sigma2: jax.Array   # [Nl]
    valid: jax.Array    # [Nl] bool
    # good-line-cutting state (cut ratios set by the line cutter; defaults
    # to the full segment, stereoFeatures.h:117-129)
    cov_sp3d: jax.Array  # [Nl, 3, 3]
    cov_ep3d: jax.Array  # [Nl, 3, 3]


def _per_level_slots(n_slots: int, nlevels: int, scale: float) -> list[int]:
    """Distribute point slots over pyramid levels like the reference
    distributes nfeatures (ORBextractor.cc:1107 weighting by 1/scale^l)."""
    ws = np.array([(1.0 / scale) ** l for l in range(nlevels)])
    raw = np.floor(ws / ws.sum() * n_slots).astype(int)
    raw[0] += n_slots - raw.sum()
    return [int(x) for x in raw]


def detect_point_features(img: jax.Array, cfg: Config, fast_th: jax.Array,
                          pyr: jax.Array | None = None):
    """Pyramid + FAST + orientation + descriptors for one camera image
    (detectPointFeatures -> ORBextractor, stereoFrame.cpp:1125-1153).
    Returns (pt_xy, pt_level, pt_angle, pt_desc, pt_score, pt_valid). All
    pyramid levels run as ONE vmapped program over zero-padded same-shape
    levels (compile-size + batching win over per-level inlining).
    ``pyr`` lets callers that already built the padded pyramid (the stereo
    front-end reuses it for sub-pixel refinement) share it."""
    cap = cfg.cap
    orb_cfg = cfg.orb
    nlv = orb_cfg.nlevels
    h, w = img.shape
    if pyr is None:
        pyr = build_pyramid_padded(img, nlv, orb_cfg.scale_factor)  # [L,H,W]
    shapes = level_shapes(h, w, nlv, orb_cfg.scale_factor)
    vh = jnp.asarray([s[0] for s in shapes])
    vw = jnp.asarray([s[1] for s in shapes])
    # equal slots per level (the reference's 1/1.2^l split is within ~10%
    # of uniform for 4 levels; uniform keeps the vmap rectangular)
    slots = cap.n_pt // nlv

    def per_level(lv_img, vh_i, vw_i):
        score = fast_ops.fast_score_map(lv_img, fast_th)
        kp = fast_ops.select_keypoints(
            score, n_out=slots, cell=orb_cfg.grid_cell, per_cell=4,
            border=orb_cfg.edge_th, valid_h=vh_i, valid_w=vw_i)
        blur = gaussian_blur(lv_img)
        ang = orb_ops.ic_angles_dense(blur, kp.xy)
        # matmul-binned BRIEF (orb.brief_descriptors_mxu design note): only
        # the patch extraction happens per level; the selector matmul runs
        # ONCE over all levels' concatenated patches.
        pf = orb_ops.brief_patches(blur, kp.xy)
        return kp, ang, pf

    # level 0 at its true shape; levels 1+ padded only to the LEVEL-1 shape
    # (full-shape padding made the dense FAST/blur maps pay 4.0x the level-0
    # area instead of 2.6x — ~35% of the detection stage was zero pixels)
    out0 = per_level(pyr[0], vh[0], vw[0])
    if nlv > 1:
        h1, w1 = shapes[1]
        pyr_small = pyr[1:, :h1, :w1]
        outs = jax.vmap(per_level)(pyr_small, vh[1:], vw[1:])
        kps, angs, pfs = jax.tree.map(
            lambda a, b: jnp.concatenate([a[None], b]), out0, outs)
    else:
        kps, angs, pfs = jax.tree.map(lambda a: a[None], out0)
    descs = orb_ops.brief_from_patches(
        pfs.reshape(nlv * slots, -1), angs.reshape(-1)).reshape(nlv, slots, -1)
    scale_l = orb_cfg.scale_factor ** jnp.arange(nlv, dtype=jnp.float32)
    lvl = jnp.repeat(jnp.arange(nlv, dtype=jnp.int32), slots)
    pad = cap.n_pt - nlv * slots

    def flat(x):
        x = x.reshape(nlv * slots, *x.shape[2:])
        if pad:
            x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        return x

    xy0 = flat(kps.xy * scale_l[:, None, None])
    lvl = jnp.pad(lvl, (0, pad)) if pad else lvl
    return (xy0, lvl, flat(angs), flat(descs), flat(kps.score),
            flat(kps.valid))


def detect_line_segments(img: jax.Array, cfg: Config):
    """LSD-analog line detection only (detectLineFeatures detection half,
    stereoFrame.cpp:1155-1201)."""
    return lsd_ops.detect_lines(
        img, n_out=cfg.cap.n_ln,
        ang_th_deg=cfg.lsd.ang_th, quant=cfg.lsd.quant,
        min_rel_length=cfg.tracking.min_line_length)


def describe_line_segments(img: jax.Array, sp: jax.Array, ep: jax.Array):
    """LBD description of detected segments (BinaryDescriptor::compute,
    stereoFrame.cpp:1203-1227)."""
    desc, _ = lbd_ops.lbd_descriptors(img, sp, ep)
    return desc


def detect_camera_features(img: jax.Array, cfg: Config,
                           fast_th: jax.Array,
                           pyr: jax.Array | None = None) -> CameraFeatures:
    """Points (all pyramid levels) + lines for one camera image.

    Replaces detectFeatures/detectPointFeatures/detectLineFeatures
    (stereoFrame.cpp:1019-1227); the reference's point/line threads become
    compiler-scheduled independent subgraphs (the stage functions above,
    fused here into one program).
    """
    xy0, lvl, angs, descs, score, valid = detect_point_features(
        img, cfg, fast_th, pyr)
    if cfg.stvo.has_lines:
        lines = detect_line_segments(img, cfg)
        ln_sp, ln_ep, ln_angle = lines.sp, lines.ep, lines.angle
        ln_desc = describe_line_segments(img, lines.sp, lines.ep)
        ln_valid = lines.valid
    else:
        # points-only operating point (Config::hasLines() false,
        # config.h:46): LSD/LBD never trace — a compile-time skip, not a
        # runtime mask (cfg is a static jit argument)
        nl = cfg.cap.n_ln
        ln_sp = jnp.zeros((nl, 2))
        ln_ep = jnp.zeros((nl, 2))
        ln_angle = jnp.zeros(nl)
        ln_desc = jnp.zeros((nl, 8), jnp.uint32)
        ln_valid = jnp.zeros(nl, bool)
    if not cfg.stvo.has_points:
        valid = jnp.zeros_like(valid)

    return CameraFeatures(
        pt_xy=xy0, pt_level=lvl,
        pt_angle=angs, pt_desc=descs,
        pt_score=score, pt_valid=valid,
        ln_sp=ln_sp, ln_ep=ln_ep, ln_angle=ln_angle,
        ln_desc=ln_desc, ln_valid=ln_valid)


def _subpixel_refine(pyr_l: jax.Array, pyr_r: jax.Array, scale_factor: float,
                     xy_l: jax.Array, level_l: jax.Array, u_r0: jax.Array,
                     win: int = 4, search: int = 4):
    """Batched SAD parabola refinement of the right-image column
    (subPixelStereoRefine_ORBSLAM, stereoFrame.cpp:340-404) on the padded
    [L, H, W] pyramid pair at each point's octave (dynamic level index; no
    control flow). Returns refined level-0 right u coordinate + validity.

    DELIBERATE DEVIATION: the reference uses w = L = 5 (11x11 window,
    11 candidate shifts); the defaults here are win = search = 4 (9x9, 9
    shifts) to cut the dominant gather volume ~35% — measured ATE impact on
    the e2e suites is below noise. Pass win=5, search=5 (via
    OrbParams.subpix_win/subpix_search) to recover the exact reference
    operating point."""
    nlv = pyr_l.shape[0]
    h, w = pyr_l.shape[1:]
    scales = jnp.asarray(scale_factor, jnp.float32) ** jnp.arange(
        nlv, dtype=jnp.float32)
    # flat element indexing into the padded pyramid: indexing ``pyr[li]``
    # with a traced level inside vmap gathers a whole [H, W] slice per point
    # (vmapped dynamic_slice is NO better: it can lower to a sequential
    # while loop over points)
    flat_l = pyr_l.reshape(-1)
    flat_r = pyr_r.reshape(-1)

    def one(xy, lvl, ur0):
        li = jnp.clip(lvl, 0, nlv - 1)
        base = li * (h * w)
        s = scales[li]
        ul = xy[0] / s
        vl = xy[1] / s
        ur = ur0 / s
        dy = jnp.arange(-win, win + 1)
        dx = jnp.arange(-win, win + 1)
        yi = jnp.clip(jnp.round(vl).astype(jnp.int32) + dy, 0, h - 1)
        xi = jnp.clip(jnp.round(ul).astype(jnp.int32) + dx, 0, w - 1)
        patch_l = flat_l[base + yi[:, None] * w + xi[None, :]]
        patch_l = patch_l - patch_l[win, win]
        # gather the right-image strip once and slide within registers
        # (per-offset patch gathers were the dominant gather volume)
        strip_x = jnp.clip(jnp.round(ur).astype(jnp.int32)
                           + jnp.arange(-search - win, search + win + 1),
                           0, w - 1)
        strip = flat_r[base + yi[:, None] * w + strip_x[None, :]]

        sad_list = []
        for k in range(2 * search + 1):             # static slices are free
            patch_r = strip[:, k:k + 2 * win + 1]
            patch_r = patch_r - patch_r[win, win]
            sad_list.append(jnp.sum(jnp.abs(patch_l - patch_r)))
        sads = jnp.stack(sad_list)
        best = jnp.argmin(sads)
        edge = (best == 0) | (best == 2 * search)
        bm1 = sads[jnp.clip(best - 1, 0, 2 * search)]
        b0 = sads[best]
        bp1 = sads[jnp.clip(best + 1, 0, 2 * search)]
        denom = jnp.maximum(bm1 + bp1 - 2 * b0, 1e-6)
        delta = jnp.clip(0.5 * (bm1 - bp1) / denom, -1.0, 1.0)
        ur_ref = (ur + (best - search) + delta) * s
        return ur_ref, jnp.logical_not(edge)

    return jax.vmap(one)(xy_l, level_l, u_r0)


def stereo_match_points(cam: CameraParams, cfg: Config,
                        feat_l: CameraFeatures, feat_r: CameraFeatures,
                        pyr_l: jax.Array, pyr_r: jax.Array) -> StereoPoints:
    """Row-banded epipolar Hamming matching + sub-pixel refine + median gate
    (extractStereoFeatures_ORBSLAM point block, stereoFrame.cpp:443-630)."""
    th_orb = 80.0  # (TH_HIGH+TH_LOW)/2, :457
    sf = cfg.orb.scale_factor
    d = hamming_matrix(feat_l.pt_desc, feat_r.pt_desc,
                       feat_l.pt_valid, feat_r.pt_valid).astype(jnp.float32)
    vr = feat_r.pt_xy[:, 1][None, :]
    vl = feat_l.pt_xy[:, 1][:, None]
    row_r = 2.0 * sf ** feat_r.pt_level.astype(jnp.float32)[None, :]
    row_ok = jnp.abs(vr - vl) <= row_r
    oct_ok = jnp.abs(feat_r.pt_level[None, :] - feat_l.pt_level[:, None]) <= 1
    ur = feat_r.pt_xy[:, 0][None, :]
    ul = feat_l.pt_xy[:, 0][:, None]
    max_d = cam.fx
    disp_ok = (ur >= ul - max_d) & (ur <= ul)  # minD=0 (:489-491)
    big = jnp.float32(1 << 16)
    d = jnp.where(row_ok & oct_ok & disp_ok, d, big)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
    ok = feat_l.pt_valid & (best_d < th_orb)

    u_r0 = feat_r.pt_xy[best, 0]
    u_ref, ref_ok = _subpixel_refine(pyr_l, pyr_r, sf, feat_l.pt_xy,
                                     feat_l.pt_level, u_r0,
                                     win=cfg.orb.subpix_win,
                                     search=cfg.orb.subpix_search)
    disp = feat_l.pt_xy[:, 0] - u_ref
    disp = jnp.where(disp <= 0, 0.01, disp)  # :574-577
    ok &= ref_ok & (disp < max_d)

    # median-distance outlier trim: th = 1.5*1.4*median (:591-592)
    med = masked_median(best_d, ok)
    ok &= best_d < 1.5 * 1.4 * med

    p3d = cam_ops.back_project_batch(cam, feat_l.pt_xy, disp)
    # per-octave inverse-variance weight sigma2 = 1/scale^(2*level)
    # (PointFeature ctor, stereoFeatures.cpp:42-47) — higher octaves carry
    # proportionally larger pixel noise in the robust weights
    sigma2 = (jnp.asarray(sf, jnp.float32)
              ** (-2.0 * feat_l.pt_level.astype(jnp.float32)))
    return StereoPoints(xy=feat_l.pt_xy, disp=disp, p3d=p3d,
                        desc=feat_l.pt_desc, level=feat_l.pt_level,
                        sigma2=sigma2, valid=ok)


def _line_overlap(sy_l, ey_l, sy_r, ey_r):
    """Vertical-interval overlap ratio (lineSegmentOverlapStereo,
    stereoFrame.cpp:1343-1371): intersection / shorter-segment extent."""
    lo = jnp.maximum(jnp.minimum(sy_l, ey_l), jnp.minimum(sy_r, ey_r))
    hi = jnp.minimum(jnp.maximum(sy_l, ey_l), jnp.maximum(sy_r, ey_r))
    inter = jnp.maximum(hi - lo, 0.0)
    shorter = jnp.minimum(jnp.abs(ey_l - sy_l), jnp.abs(ey_r - sy_r))
    return inter / jnp.maximum(shorter, 1e-6)


def _endpoint_cov(cam: CameraParams, u, v, disp):
    """Analytic 3D endpoint covariance from (u, v, disp) noise
    (stereoFrame.cpp:706-759 closed form)."""
    px = u - cam.cx
    py = v - cam.cy
    f = cam.fx
    d2 = disp * disp
    c = jnp.stack([
        jnp.stack([d2 + 2 * px * px, 2 * px * py, 2 * f * px]),
        jnp.stack([2 * px * py, d2 + 2 * py * py, 2 * f * py]),
        jnp.stack([2 * f * px, 2 * f * py, 2 * f * f + 0 * d2]),
    ])
    return c * (cam.baseline ** 2) / jnp.maximum(d2 * d2, 1e-12)


def _max_eig3(m: jax.Array) -> jax.Array:
    """Largest eigenvalue of a symmetric 3x3 (power iteration, fixed steps)."""
    v = jnp.ones(3, m.dtype) / jnp.sqrt(3.0)
    def body(_, v):
        w = m @ v
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-12)
    v = jax.lax.fori_loop(0, 12, body, v)
    return v @ (m @ v)


def stereo_match_lines(cam: CameraParams, cfg: Config,
                       feat_l: CameraFeatures,
                       feat_r: CameraFeatures) -> StereoLines:
    """Mutual-best LBD matching + distinctiveness gate + geometric gates +
    intersection disparity (line block, stereoFrame.cpp:632-767)."""
    tr = cfg.tracking
    d = hamming_matrix(feat_l.ln_desc, feat_r.ln_desc,
                       feat_l.ln_valid, feat_r.ln_valid).astype(jnp.float32)
    m = mutual_best(d)
    # distinctiveness: (d2 - d1) must exceed MAD(d2-d1)*desc_th_l
    # (lineDescriptorMAD nn12 path + gate at :681-683); two-pass min beats
    # a full row sort
    d1 = jnp.min(d, axis=1)
    d2 = jnp.min(jnp.where(d <= d1[:, None], jnp.inf, d), axis=1)
    # duplicated minima count as gap 0 (knnMatch's second neighbor includes
    # ties) so exact-tie ambiguous matches are rejected by the gate
    tie = jnp.sum(d == d1[:, None], axis=1) > 1
    gap = jnp.where(tie | ~jnp.isfinite(d2), 0.0, d2 - d1)
    gap_th = masked_stdv_mad_nozero(gap, m.valid) * tr.desc_th_l
    ok = m.valid & (gap > gap_th)

    sp_l, ep_l = feat_l.ln_sp, feat_l.ln_ep
    sp_r = feat_r.ln_sp[m.idx]
    ep_r = feat_r.ln_ep[m.idx]

    def line_coeffs(sp, ep):
        s = jnp.concatenate([sp, jnp.ones_like(sp[:, :1])], axis=1)
        e = jnp.concatenate([ep, jnp.ones_like(ep[:, :1])], axis=1)
        le = jnp.cross(s, e)
        n = jnp.sqrt(le[:, 0] ** 2 + le[:, 1] ** 2)
        return le / jnp.maximum(n, 1e-9)[:, None], le

    le_l, _ = line_coeffs(sp_l, ep_l)
    _, le_r_raw = line_coeffs(sp_r, ep_r)

    overlap = _line_overlap(sp_l[:, 1], ep_l[:, 1], sp_r[:, 1], ep_r[:, 1])
    # intersect left endpoint rows with the right line (:693-696)
    a, b2, c2 = le_r_raw[:, 0], le_r_raw[:, 1], le_r_raw[:, 2]
    a_safe = jnp.where(jnp.abs(a) < 1e-9, 1e-9, a)
    x_r_s = -(c2 + b2 * sp_l[:, 1]) / a_safe
    x_r_e = -(c2 + b2 * ep_l[:, 1]) / a_safe
    disp_s = sp_l[:, 0] - x_r_s
    disp_e = ep_l[:, 0] - x_r_e

    ok &= (disp_s >= tr.min_disp) & (disp_e >= tr.min_disp)
    ok &= jnp.abs(le_l[:, 0]) > tr.line_horiz_th
    ok &= overlap > tr.stereo_overlap_th

    sp3d = cam_ops.back_project_batch(cam, sp_l, disp_s)
    ep3d = cam_ops.back_project_batch(cam, ep_l, disp_e)

    cov_s = jax.vmap(lambda u, v, dd: _endpoint_cov(cam, u, v, dd))(
        sp_l[:, 0], sp_l[:, 1], disp_s)
    cov_e = jax.vmap(lambda u, v, dd: _endpoint_cov(cam, u, v, dd))(
        ep_l[:, 0], ep_l[:, 1], disp_e)
    max_eig = jnp.maximum(jax.vmap(_max_eig3)(cov_s), jax.vmap(_max_eig3)(cov_e))
    ok &= max_eig < tr.line_cov_th

    return StereoLines(
        sp=sp_l, ep=ep_l, sdisp=disp_s, edisp=disp_e, sp3d=sp3d, ep3d=ep3d,
        le=le_l, angle=feat_l.ln_angle, desc=feat_l.ln_desc,
        sigma2=jnp.ones_like(disp_s), valid=ok,
        cov_sp3d=cov_s, cov_ep3d=cov_e)


class StereoFrame(NamedTuple):
    """Full per-frame state (StereoFrame, stereoFrame.h:104-180)."""
    points: StereoPoints
    lines: StereoLines
    feat_l: CameraFeatures


@partial(jax.jit, static_argnames=("cfg",))
def process_stereo_pair(img_l: jax.Array, img_r: jax.Array, cfg: Config,
                        fast_th: jax.Array) -> StereoFrame:
    """The whole front-end for one rectified stereo pair in one device call
    (extractStereoFeatures_ORBSLAM, stereoFrame.cpp:411-767).

    Accepts any image dtype and casts to float32 ON DEVICE: feeding uint8
    camera bytes host->device costs 4x less transfer than float32 (a
    24-frame EuRoC chunk is 17 MB as uint8, 69 MB as float32)."""
    img_l = img_l.astype(jnp.float32)
    img_r = img_r.astype(jnp.float32)
    cam = cfg.camera
    # ONE pyramid per camera, shared by detection and sub-pixel refinement
    pyrs = jax.vmap(lambda im: build_pyramid_padded(
        im, cfg.orb.nlevels, cfg.orb.scale_factor))(
        jnp.stack([img_l, img_r]))
    feats = jax.vmap(lambda im, py: detect_camera_features(
        im, cfg, fast_th, py))(jnp.stack([img_l, img_r]), pyrs)
    feat_l = jax.tree.map(lambda x: x[0], feats)
    feat_r = jax.tree.map(lambda x: x[1], feats)
    pts = stereo_match_points(cam, cfg, feat_l, feat_r, pyrs[0], pyrs[1])
    if cfg.stvo.has_lines:
        lns = stereo_match_lines(cam, cfg, feat_l, feat_r)
    else:
        nl = cfg.cap.n_ln
        z2 = jnp.zeros((nl, 2))
        z1 = jnp.zeros(nl)
        lns = StereoLines(
            sp=z2, ep=z2, sdisp=z1, edisp=z1,
            sp3d=jnp.zeros((nl, 3)), ep3d=jnp.zeros((nl, 3)),
            le=jnp.zeros((nl, 3)), angle=z1,
            desc=jnp.zeros((nl, 8), jnp.uint32), sigma2=jnp.ones(nl),
            valid=jnp.zeros(nl, bool),
            cov_sp3d=jnp.zeros((nl, 3, 3)), cov_ep3d=jnp.zeros((nl, 3, 3)))
    return StereoFrame(points=pts, lines=lns, feat_l=feat_l)


def estimate_line_uncertainty(cam: CameraParams, cfg: Config,
                              lines: StereoLines) -> StereoLines:
    """Refresh endpoint covariances with the disparity-stdev model
    (estimateStereoUncertainty, stereoFrame.cpp:1448-1484): disparity sigma =
    ratio_disp_std * disp, or ratio_disp_std_hor * disp for near-horizontal
    lines (|le_x| <= 0.15)."""
    ratio = jnp.where(jnp.abs(lines.le[:, 0]) <= 0.15,
                      cfg.stvo.ratio_disp_std_hor, cfg.stvo.ratio_disp_std)

    def cov_from(u, v, disp, r):
        # J = d(X,Y,Z)/d(u,v,disp) (getJacob2D_3D, stereoFrame.cpp:1375-1392)
        b = cam.baseline
        f = cam.fx
        d = jnp.maximum(disp, 1e-6)
        j = jnp.stack([
            jnp.stack([b / d, 0.0 * d, -b * (u - cam.cx) / (d * d)]),
            jnp.stack([0.0 * d, b / d, -b * (v - cam.cy) / (d * d)]),
            jnp.stack([0.0 * d, 0.0 * d, -f * b / (d * d)]),
        ])
        cov_uvd = jnp.diag(jnp.stack([1.0 + 0.0 * d, 1.0 + 0.0 * d,
                                      (r * d) ** 2]))
        return j @ cov_uvd @ j.T

    cov_s = jax.vmap(cov_from)(lines.sp[:, 0], lines.sp[:, 1], lines.sdisp, ratio)
    cov_e = jax.vmap(cov_from)(lines.ep[:, 0], lines.ep[:, 1], lines.edisp, ratio)
    return lines._replace(cov_sp3d=cov_s, cov_ep3d=cov_e)
