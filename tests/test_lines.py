"""Line detection + LBD descriptors on synthetic segment renderings."""

import jax.numpy as jnp
import numpy as np
import pytest

from gfplslam_tpu.ops import lbd, lsd
from gfplslam_tpu.ops.hamming import hamming_matrix


def render_segments(segs, h=120, w=160, fg=255.0):
    """Draw bright anti-aliased segments on black (max-blend bilinear
    footprints so gradient orientation stays smooth along the line)."""
    img = np.zeros((h, w), np.float32)
    for (x0, y0, x1, y1) in segs:
        n = int(max(abs(x1 - x0), abs(y1 - y0)) * 3 + 2)
        for t in np.linspace(0, 1, n):
            x = x0 + t * (x1 - x0)
            y = y0 + t * (y1 - y0)
            xi, yi = int(np.floor(x)), int(np.floor(y))
            fx_, fy_ = x - xi, y - yi
            for dy, wy in ((0, 1 - fy_), (1, fy_)):
                for dx, wx in ((0, 1 - fx_), (1, fx_)):
                    yy, xx = yi + dy, xi + dx
                    if 0 <= yy < h and 0 <= xx < w:
                        img[yy, xx] = max(img[yy, xx], fg * wy * wx)
    return img


SEGS = [(20, 20, 100, 20), (30, 90, 130, 40), (140, 10, 140, 100)]


def endpoints_match(found_sp, found_ep, seg, tol=6.0):
    s = np.array(seg[:2], float)
    e = np.array(seg[2:], float)
    d1 = min(np.linalg.norm(found_sp - s), np.linalg.norm(found_sp - e))
    d2 = min(np.linalg.norm(found_ep - e), np.linalg.norm(found_ep - s))
    return d1 < tol and d2 < tol


def test_detects_synthetic_segments():
    img = render_segments(SEGS)
    out = lsd.detect_lines(jnp.asarray(img), n_out=64)
    v = np.asarray(out.valid)
    sp = np.asarray(out.sp)
    ep = np.asarray(out.ep)
    # every painted segment recovered (edges may double: one line each side)
    for seg in SEGS:
        hits = [i for i in np.nonzero(v)[0]
                if endpoints_match(sp[i], ep[i], seg)]
        assert hits, f"segment {seg} not found; got {sp[v][:6]} {ep[v][:6]}"


def test_no_lines_on_flat():
    img = np.full((80, 80), 50.0, np.float32)
    out = lsd.detect_lines(jnp.asarray(img), n_out=32)
    assert int(np.sum(np.asarray(out.valid))) == 0


def test_min_length_gate():
    # a short 6px segment on a large canvas: every edge component (~6-9 px)
    # sits below min_rel_length * diagonal (0.025 * 344 = 8.6 px ... use a
    # 4px segment to stay clearly below)
    img = render_segments([(100, 100, 104, 100)], h=200, w=280)
    out = lsd.detect_lines(jnp.asarray(img), n_out=32)
    assert int(np.sum(np.asarray(out.valid))) == 0


def test_angle_convention():
    img = render_segments([(20, 30, 100, 30)])
    out = lsd.detect_lines(jnp.asarray(img), n_out=16)
    v = np.asarray(out.valid)
    assert v.any()
    ang = np.asarray(out.angle)[v]
    assert np.all(np.abs(np.sin(ang)) < 0.15)  # near-horizontal


def test_lbd_matches_same_line_across_shift(rng):
    """The same scene shifted 3px right: descriptors of corresponding lines
    should be far closer than those of different lines."""
    base = render_segments(SEGS) + rng.normal(0, 4, size=(120, 160)).astype(np.float32)
    shifted = np.roll(base, 3, axis=1)
    la = lsd.detect_lines(jnp.asarray(base), n_out=16)
    lb = lsd.detect_lines(jnp.asarray(shifted), n_out=16)
    va, vb = np.asarray(la.valid), np.asarray(lb.valid)
    assert va.sum() >= 3 and vb.sum() >= 3
    da, _ = lbd.lbd_descriptors(jnp.asarray(base), la.sp, la.ep)
    db, _ = lbd.lbd_descriptors(jnp.asarray(shifted), lb.sp, lb.ep)
    d = np.asarray(hamming_matrix(da, db)).astype(float)
    d = d[va][:, vb]
    spa = np.asarray(la.sp)[va]
    spb = np.asarray(lb.sp)[vb] - np.array([3.0, 0.0])
    # ground-truth correspondence by start-point proximity
    for i in range(len(spa)):
        j = int(np.argmin(np.linalg.norm(spb - spa[i], axis=1)))
        if np.linalg.norm(spb[j] - spa[i]) < 5:
            others = np.delete(d[i], j)
            assert d[i, j] <= others.min() + 20, (i, j, d[i, j], others.min())


def test_lbd_shapes(rng):
    img = rng.uniform(0, 255, (64, 64)).astype(np.float32)
    sp = jnp.asarray([[10.0, 10.0], [5.0, 50.0]])
    ep = jnp.asarray([[50.0, 12.0], [60.0, 45.0]])
    binary, feats = lbd.lbd_descriptors(jnp.asarray(img), sp, ep)
    assert binary.shape == (2, 8) and binary.dtype == jnp.uint32
    assert feats.shape == (2, 72)
    assert np.all(np.isfinite(np.asarray(feats)))
