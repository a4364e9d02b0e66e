"""Pose-only robust Gauss-Newton over point + line reprojection residuals.

Behavioral parity with the reference's two-stage solver
(stereoFrameHandler.cpp:1939-2245): stage 1 ``max_iters`` GN on all matches,
MAD-based outlier rejection (``inlier_k * mad``, :2058-2116), stage 2
``max_iters_ref`` refinement, motion-step sanity gate + identity fallback
(:1984-2028). The residual model is the reference's scalarized form
(optimizeFunctions, :2118-2245):

- point residual  r = || project(DT * P) - pl_obs ||
- line residual   r = || (l . proj(DT*sP), l . proj(DT*eP)) ||  (signed
  endpoint-to-line distances against the observed 2D line ``le_obs``)
- robust weight   w = 1 / (1 + r^2 sigma^2)
- update          H dx = g ;  DT <- DT * exp(dx)^-1,  DT_cov = H^-1

Design: per-feature Jacobians are one vmapped closed form; H/g are
masked einsum reductions; the GN loop is a ``lax.while_loop`` with early-stop
on error change; the whole two-stage solve + fallback logic is a single jitted
function of fixed-capacity arrays.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gfplslam_tpu.config import CameraParams, OptimizerParams
from gfplslam_tpu.utils import se3
from gfplslam_tpu.utils.robust import masked_stdv_mad


class PointMatches(NamedTuple):
    """Cross-frame point matches (PointFeature lists, stereoFeatures.h:51-61)."""
    p3d: jax.Array     # [N, 3] 3D point in previous camera frame
    obs: jax.Array     # [N, 2] observed pixel in current frame
    sigma2: jax.Array  # [N] residual information scale (1.0 default)
    valid: jax.Array   # [N] bool (match exists & inlier)


class LineMatches(NamedTuple):
    """Cross-frame line matches (LineFeature lists, stereoFeatures.h:96-129)."""
    sp3d: jax.Array    # [M, 3] start endpoint, previous frame
    ep3d: jax.Array    # [M, 3] end endpoint, previous frame
    le_obs: jax.Array  # [M, 3] normalized 2D line coefficients in current
    sigma2: jax.Array  # [M]
    valid: jax.Array   # [M] bool


class PoseResult(NamedTuple):
    dt: jax.Array          # [4, 4] optimized relative pose (curr->prev sense
                           # matches reference DT before its final inverse)
    dt_cov: jax.Array      # [6, 6]
    err: jax.Array         # scalar normalized error (-1 on fallback)
    accepted: jax.Array    # bool: optimization accepted (not identity fallback)
    pt_inlier: jax.Array   # [N] bool final point inlier mask
    ln_inlier: jax.Array   # [M] bool final line inlier mask


def _point_terms(cam: CameraParams, dt: jax.Array, pts: PointMatches,
                 homog_th: float):
    """Per-point (J[6], r, w) of the scalarized residual
    (optimizeFunctions point block, stereoFrameHandler.cpp:2131-2166)."""
    def one(p, obs, s2):
        pc = dt[:3, :3] @ p + dt[:3, 3]
        gx, gy, gz = pc[0], pc[1], pc[2]
        inv_z = 1.0 / jnp.where(jnp.abs(gz) < 1e-12, 1e-12, gz)
        proj = jnp.stack([cam.fx * gx * inv_z + cam.cx,
                          cam.fy * gy * inv_z + cam.cy])
        err = proj - obs
        r = jnp.linalg.norm(err)
        gz2 = gz * gz
        fgz2 = cam.fx / jnp.maximum(homog_th, gz2)
        dx, dy = err[0], err[1]
        j = jnp.stack([
            fgz2 * dx * gz,
            fgz2 * dy * gz,
            -fgz2 * (gx * dx + gy * dy),
            -fgz2 * (gx * gy * dx + gy * gy * dy + gz * gz * dy),
            fgz2 * (gx * gx * dx + gz * gz * dx + gx * gy * dy),
            fgz2 * (gx * gz * dy - gy * gz * dx),
        ]) / jnp.maximum(homog_th, r)
        w = 1.0 / (1.0 + r * r * s2)
        return j, r, w
    return jax.vmap(one)(pts.p3d, pts.obs, pts.sigma2)


def _line_endpoint_jac(cam: CameraParams, pc: jax.Array, lx: jax.Array,
                       ly: jax.Array, homog_th: float) -> jax.Array:
    """d(l . proj(p))/d(twist) for one transformed endpoint
    (stereoFrameHandler.cpp:2197-2215)."""
    gx, gy, gz = pc[0], pc[1], pc[2]
    gz2 = gz * gz
    fgz2 = cam.fx / jnp.maximum(homog_th, gz2)
    return jnp.stack([
        fgz2 * lx * gz,
        fgz2 * ly * gz,
        -fgz2 * (gx * lx + gy * ly),
        -fgz2 * (gx * gy * lx + gy * gy * ly + gz * gz * ly),
        fgz2 * (gx * gx * lx + gz * gz * lx + gx * gy * ly),
        fgz2 * (gx * gz * ly - gy * gz * lx),
    ])


def _line_terms(cam: CameraParams, dt: jax.Array, lns: LineMatches,
                homog_th: float):
    """Per-line (J[6], r, w) (optimizeFunctions line block, :2169-2239)."""
    def one(sp, ep, l_obs, s2):
        spc = dt[:3, :3] @ sp + dt[:3, 3]
        epc = dt[:3, :3] @ ep + dt[:3, 3]
        def proj(pc):
            inv_z = 1.0 / jnp.where(jnp.abs(pc[2]) < 1e-12, 1e-12, pc[2])
            return jnp.stack([cam.fx * pc[0] * inv_z + cam.cx,
                              cam.fy * pc[1] * inv_z + cam.cy])
        sproj, eproj = proj(spc), proj(epc)
        lx, ly, lz = l_obs[0], l_obs[1], l_obs[2]
        ds = lx * sproj[0] + ly * sproj[1] + lz
        de = lx * eproj[0] + ly * eproj[1] + lz
        r = jnp.sqrt(ds * ds + de * de)
        js = _line_endpoint_jac(cam, spc, lx, ly, homog_th)
        je = _line_endpoint_jac(cam, epc, lx, ly, homog_th)
        j = (js * ds + je * de) / jnp.maximum(homog_th, r)
        w = 1.0 / (1.0 + r * r * s2)
        return j, r, w
    return jax.vmap(one)(lns.sp3d, lns.ep3d, lns.le_obs, lns.sigma2)


def build_normal_equations(cam: CameraParams, dt: jax.Array,
                           pts: PointMatches, lns: LineMatches,
                           homog_th: float = 1e-7):
    """Masked H (6x6), g (6), normalized error (optimizeFunctions)."""
    jp, rp, wp = _point_terms(cam, dt, pts, homog_th)
    jl, rl, wl = _line_terms(cam, dt, lns, homog_th)
    mp = pts.valid.astype(jp.dtype)
    ml = lns.valid.astype(jl.dtype)
    h = (jnp.einsum("ni,nj,n->ij", jp, jp, wp * mp)
         + jnp.einsum("ni,nj,n->ij", jl, jl, wl * ml))
    g = (jnp.einsum("ni,n->i", jp, rp * wp * mp)
         + jnp.einsum("ni,n->i", jl, rl * wl * ml))
    n = jnp.sum(mp) + jnp.sum(ml)
    e = (jnp.sum(rp * rp * wp * mp) + jnp.sum(rl * rl * wl * ml)) / jnp.maximum(n, 1.0)
    return h, g, e


def gauss_newton(cam: CameraParams, dt0: jax.Array, pts: PointMatches,
                 lns: LineMatches, opt: OptimizerParams, max_iters: int):
    """GN loop with early stop (gaussNewtonOptimization, :2032-2056).

    Unrolled with masked updates instead of ``lax.while_loop``: per-iteration
    device-loop overhead dwarfs the (tiny) body, and converged iterations are
    no-ops under the ``done`` mask — same fixed budget as the reference."""
    dt = dt0
    err_prev = jnp.asarray(1e9, dt0.dtype)
    done = jnp.asarray(False)
    for _ in range(max_iters):
        h, g, err = build_normal_equations(cam, dt, pts, lns, opt.homog_th)
        stop = ((jnp.abs(err - err_prev) < opt.min_error_change)
                | (err < opt.min_error))
        # LDLT-equivalent 6x6 solve; tiny Tikhonov guard keeps it finite when
        # H is singular (reference relies on Eigen returning garbage then the
        # is_finite gate catching it; we keep the gate too). NOTE: an
        # unrolled unpivoted f32 Cholesky here is NOT safe — H entries are
        # fx^2-scale (~1e6-1e8) and f32 round-off makes ~6% of real GN
        # Hessians indefinite-by-epsilon, which turned loop-closure
        # verifications into NaN rejections; the pivoted solve is kept.
        dx = jnp.linalg.solve(h + 1e-12 * jnp.eye(6, dtype=h.dtype), g)
        new_dt = dt @ se3.inverse_se3(se3.expmap_se3(dx))
        small = jnp.linalg.norm(dx) < 1e-7
        dt = jnp.where(done | stop, dt, new_dt)
        err_prev = jnp.where(done, err_prev, err)
        done = done | stop | small
    h, g, err = build_normal_equations(cam, dt, pts, lns, opt.homog_th)
    cov = jnp.linalg.inv(h + 1e-12 * jnp.eye(6, dtype=h.dtype))
    return dt, cov, err


def remove_outliers(cam: CameraParams, dt: jax.Array, pts: PointMatches,
                    lns: LineMatches, inlier_k: float):
    """MAD residual gate per family (removeOutliers, :2058-2116)."""
    _, rp, _ = _point_terms(cam, dt, pts, 1e-7)
    _, rl, _ = _line_terms(cam, dt, lns, 1e-7)
    rp = rp * jnp.sqrt(pts.sigma2)
    rl = rl * jnp.sqrt(lns.sigma2)
    th_p = inlier_k * masked_stdv_mad(rp, pts.valid)
    th_l = inlier_k * masked_stdv_mad(rl, lns.valid)
    return (pts.valid & (rp <= th_p)), (lns.valid & (rl <= th_l))


@partial(jax.jit, static_argnames=("cam", "opt"))
def optimize_pose(cam: CameraParams, dt_ini: jax.Array, pts: PointMatches,
                  lns: LineMatches, opt: OptimizerParams,
                  delta_t: jax.Array | float = 1.0 / 20.0) -> PoseResult:
    """Two-stage robust pose solve (optimizePose, :1939-2030).

    Returns DT in the reference's internal sense (prev<-curr is applied by the
    caller as ``curr.Tfw = prev.Tfw @ inverse(DT)``); ``accepted`` mirrors the
    motion-gate + finite checks that otherwise trigger identity fallback and a
    track-loss increment.
    """
    n_in = jnp.sum(pts.valid) + jnp.sum(lns.valid)
    enough = n_in > opt.min_features

    # stage 1 on all matches
    dt1, _, _ = gauss_newton(cam, dt_ini, pts, lns, opt, opt.max_iters)
    stage1_ok = se3.is_finite(dt1) & enough
    # outlier strip at the stage-1 estimate
    pt_in, ln_in = remove_outliers(cam, dt1, pts, lns, opt.inlier_k)
    pt_in = jnp.where(stage1_ok, pt_in, pts.valid)
    ln_in = jnp.where(stage1_ok, ln_in, lns.valid)
    n_in2 = jnp.sum(pt_in) + jnp.sum(ln_in)
    enough2 = n_in2 > opt.min_features

    # stage 2 refinement from DT_ini on inliers only (reference restarts from
    # DT, the unrefined initial value, :1957-1964)
    pts2 = pts._replace(valid=pt_in)
    lns2 = lns._replace(valid=ln_in)
    dt2, cov2, err2 = gauss_newton(cam, dt_ini, pts2, lns2, opt, opt.max_iters_ref)

    ok = stage1_ok & enough2 & se3.is_finite(dt2) & se3.is_finite(cov2)
    dt_est = jnp.where(ok, dt2, jnp.eye(4, dtype=dt_ini.dtype))
    cov = jnp.where(ok, cov2, jnp.zeros((6, 6), dtype=dt_ini.dtype))

    # motion-step sanity gate on the estimated step (:1984-2012): reject
    # translations exceeding motion_step_th * dt seconds
    trans = jnp.linalg.norm(se3.inverse_se3(dt_est)[:3, 3])
    step_ok = trans < opt.motion_step_th * jnp.asarray(delta_t, dt_ini.dtype)
    accepted = ok & step_ok
    dt_final = jnp.where(accepted, dt_est, jnp.eye(4, dtype=dt_ini.dtype))
    err_final = jnp.where(accepted, err2, -1.0)

    return PoseResult(dt=dt_final, dt_cov=cov, err=err_final,
                      accepted=accepted, pt_inlier=pt_in, ln_inlier=ln_in)
