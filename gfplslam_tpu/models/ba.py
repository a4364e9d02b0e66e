"""Sliding-window bundle adjustment via Schur complement, batched LM.

Capability parity with the reference's hand-rolled local/global BA
(``localBundleAdjustment``/``levMarquardtOptimizationLBA``,
mapHandler.cpp:1108-1838; global variant :1844-2548): Levenberg-Marquardt
over local keyframe poses + point landmarks (3-dof) + line landmarks
(two 3-dof endpoints), robust weight 1/(1+r^2 sigma^2), lambda *=/= k
schedule, outlier-observation marking.

Design (replaces the reference's dense NxN Hessian +
SimplicialLDLT, :1429-1441): the proper sparse structure is exploited —
landmark 3x3 / line 6x6 blocks inverted in batch, the camera system reduced
by the Schur complement to a dense [6K, 6K] (K = window size <= 8..16)
solved with Cholesky on device. All observation loops are scatter-adds over
fixed-capacity observation tables; the LM loop is a ``lax.while_loop``.

Pose convention: ``kf_pose`` is cam->world; the solver perturbs the inverse
(world->cam) on the left: T_cw <- exp(dx) T_cw. Twist ordering [rho, phi].
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gfplslam_tpu.config import CameraParams
from gfplslam_tpu.models import ba_core
from gfplslam_tpu.utils import se3


class BAProblem(NamedTuple):
    """Padded BA window. K keyframes, P points, L lines, Op/Ol observations."""
    kf_pose: jax.Array    # [K, 4, 4] cam->world
    kf_free: jax.Array    # [K] bool — optimized (False = gauge/frozen)
    kf_valid: jax.Array   # [K] bool — participates at all
    pt_pos: jax.Array     # [P, 3] world
    pt_valid: jax.Array   # [P] bool
    ln_sp: jax.Array      # [L, 3] world
    ln_ep: jax.Array      # [L, 3]
    ln_valid: jax.Array   # [L] bool
    po_kf: jax.Array      # [Op] int32 window-kf slot per point obs
    po_lm: jax.Array      # [Op] int32 point-landmark slot
    po_uv: jax.Array      # [Op, 2] observed pixel
    po_sigma2: jax.Array  # [Op]
    po_valid: jax.Array   # [Op] bool
    lo_kf: jax.Array      # [Ol] int32
    lo_lm: jax.Array      # [Ol] int32
    lo_le: jax.Array      # [Ol, 3] observed 2D line coefficients
    lo_sigma2: jax.Array  # [Ol]
    lo_valid: jax.Array   # [Ol] bool


class BAResult(NamedTuple):
    kf_pose: jax.Array
    pt_pos: jax.Array
    ln_sp: jax.Array
    ln_ep: jax.Array
    err: jax.Array        # final mean robust error
    iters: jax.Array
    po_inlier: jax.Array  # [Op] bool post-BA outlier marking
    lo_inlier: jax.Array  # [Ol] bool


def _point_residuals(cam: CameraParams, t_cw: jax.Array, prob: BAProblem,
                     pt_pos: jax.Array):
    """Per point-obs: residual [2], J_pose [2,6], J_lm [2,3], weight."""
    def one(kf, lm, uv, s2):
        t = t_cw[kf]
        x = pt_pos[lm]
        pc = t[:3, :3] @ x + t[:3, 3]
        z = jnp.where(jnp.abs(pc[2]) < 1e-9, 1e-9, pc[2])
        iz = 1.0 / z
        proj = jnp.stack([cam.fx * pc[0] * iz + cam.cx,
                          cam.fy * pc[1] * iz + cam.cy])
        r = proj - uv
        j_proj = jnp.stack([
            jnp.stack([cam.fx * iz, 0.0 * iz, -cam.fx * pc[0] * iz * iz]),
            jnp.stack([0.0 * iz, cam.fy * iz, -cam.fy * pc[1] * iz * iz]),
        ])
        # d pc / d twist = [I | -skew(pc)] for T_cw <- exp(dx) T_cw
        dpc = jnp.concatenate([jnp.eye(3), -se3.skew(pc)], axis=1)  # [3,6]
        j_pose = j_proj @ dpc
        j_lm = j_proj @ t[:3, :3]
        r2 = jnp.dot(r, r)
        w = 1.0 / (1.0 + r2 * s2)
        return r, j_pose, j_lm, w
    return jax.vmap(one)(prob.po_kf, prob.po_lm, prob.po_uv, prob.po_sigma2)


def _line_residuals(cam: CameraParams, t_cw: jax.Array, prob: BAProblem,
                    ln_sp: jax.Array, ln_ep: jax.Array):
    """Per line-obs: residual [2] (signed endpoint-line distances),
    J_pose [2,6], J_sp [2,3], J_ep [2,3], weight."""
    def one(kf, lm, le, s2):
        t = t_cw[kf]
        lx, ly, lz = le[0], le[1], le[2]

        def endpoint(xw):
            pc = t[:3, :3] @ xw + t[:3, 3]
            z = jnp.where(jnp.abs(pc[2]) < 1e-9, 1e-9, pc[2])
            iz = 1.0 / z
            proj = jnp.stack([cam.fx * pc[0] * iz + cam.cx,
                              cam.fy * pc[1] * iz + cam.cy])
            r = lx * proj[0] + ly * proj[1] + lz
            j_proj = jnp.stack([
                jnp.stack([cam.fx * iz, 0.0 * iz, -cam.fx * pc[0] * iz * iz]),
                jnp.stack([0.0 * iz, cam.fy * iz, -cam.fy * pc[1] * iz * iz]),
            ])
            j_uv = jnp.stack([lx, ly])          # d r / d proj
            dpc = jnp.concatenate([jnp.eye(3), -se3.skew(pc)], axis=1)
            j_pose = j_uv @ (j_proj @ dpc)      # [6]
            j_lm = j_uv @ (j_proj @ t[:3, :3])  # [3]
            return r, j_pose, j_lm

        rs, jps, jls = endpoint(ln_sp[lm])
        re, jpe, jle = endpoint(ln_ep[lm])
        r = jnp.stack([rs, re])
        j_pose = jnp.stack([jps, jpe])          # [2,6]
        j_sp = jnp.stack([jls, jnp.zeros(3)])   # [2,3]
        j_ep = jnp.stack([jnp.zeros(3), jle])
        r2 = jnp.dot(r, r)
        w = 1.0 / (1.0 + r2 * s2)
        return r, j_pose, j_sp, j_ep, w
    return jax.vmap(one)(prob.lo_kf, prob.lo_lm, prob.lo_le, prob.lo_sigma2)


def _point_chi2(cam: CameraParams, t_cw: jax.Array, prob: BAProblem,
                pt_pos: jax.Array) -> jax.Array:
    """Per point-obs squared reprojection error [Op] (no Jacobians — used by
    the per-landmark step-acceptance test, which needs only residuals)."""
    t = t_cw[prob.po_kf]                                   # [Op, 4, 4]
    x = pt_pos[prob.po_lm]                                 # [Op, 3]
    pc = jnp.einsum("nij,nj->ni", t[:, :3, :3], x) + t[:, :3, 3]
    z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    proj = jnp.stack([cam.fx * pc[:, 0] / z + cam.cx,
                      cam.fy * pc[:, 1] / z + cam.cy], axis=-1)
    r = proj - prob.po_uv
    return jnp.sum(r * r, axis=-1)


def _line_chi2(cam: CameraParams, t_cw: jax.Array, prob: BAProblem,
               ln_sp: jax.Array, ln_ep: jax.Array) -> jax.Array:
    """Per line-obs squared endpoint-to-line error [Ol]."""
    t = t_cw[prob.lo_kf]

    def ep_err(xw):
        pc = jnp.einsum("nij,nj->ni", t[:, :3, :3], xw) + t[:, :3, 3]
        z = jnp.where(jnp.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        le = prob.lo_le
        return le[:, 0] * u + le[:, 1] * v + le[:, 2]

    rs = ep_err(ln_sp[prob.lo_lm])
    re = ep_err(ln_ep[prob.lo_lm])
    return rs * rs + re * re


def _total_error(cam, t_cw, prob, pt_pos, ln_sp, ln_ep):
    rp, _, _, wp = _point_residuals(cam, t_cw, prob, pt_pos)
    rl, _, _, _, wl = _line_residuals(cam, t_cw, prob, ln_sp, ln_ep)
    mp = prob.po_valid
    ml = prob.lo_valid
    ep = jnp.sum(jnp.where(mp, jnp.sum(rp * rp, -1) * wp, 0.0))
    el = jnp.sum(jnp.where(ml, jnp.sum(rl * rl, -1) * wl, 0.0))
    n = jnp.sum(mp) + jnp.sum(ml)
    return (ep + el) / jnp.maximum(n, 1)


@partial(jax.jit, static_argnames=("cam", "max_iters"))
def solve_ba(cam: CameraParams, prob: BAProblem, lambda0: float = 1e-3,
             lambda_k: float = 10.0, max_iters: int = 20,
             inlier_chi2: float = 7.815, tol: float = 1e-5) -> BAResult:
    """LM loop with Schur-complement camera solve.

    lambda schedule and iteration budget mirror lambda_lba_lm/_k and
    max_iters_lba (config.cpp:55-57, mapHandler.cpp:1654-1678). After
    convergence, observations with robust chi2 above ``inlier_chi2`` are
    marked outliers (the reference's post-BA marking, :1714-1836).
    """
    t_cw0 = jax.vmap(se3.inverse_se3)(prob.kf_pose)

    # one-hot selectors + obs->constant freezing, hoisted out of the LM loop
    sel = ba_core.make_selectors(prob)
    kf_opt = prob.kf_free & prob.kf_valid

    def build_blocks(t_cw, pt_pos, ln_sp, ln_ep):
        bk = ba_core.build_blocks(cam, prob, sel, _point_residuals,
                                  _line_residuals, t_cw, pt_pos, ln_sp,
                                  ln_ep)
        return bk, bk.err_sum / jnp.maximum(bk.err_cnt, 1.0)

    def solve_with_lam(bk, t_cw, pt_pos, ln_sp, ln_ep, lam):
        """Damped Schur solve + retraction from precomputed blocks (the only
        lambda-dependent part of an LM iteration)."""
        hpp_inv, hll_inv = ba_core.landmark_inverses(bk, lam)
        s_full, rhs = ba_core.schur_reduce(bk, hpp_inv, hll_inv)
        dx_cam = ba_core.camera_solve(s_full, rhs, kf_opt, lam)
        dx_pt, dx_ln = ba_core.back_substitute(bk, hpp_inv, hll_inv, dx_cam)
        t_new, pt_new, sp_new, ep_new = ba_core.retract(
            bk, t_cw, pt_pos, ln_sp, ln_ep, dx_cam, dx_pt, dx_ln)
        # per-landmark acceptance: a landmark step that worsens its own
        # unweighted chi2 (at the candidate cameras) is reverted — the
        # saturating robust weight makes the global LM accept test blind to
        # individual landmark fly-away (see ba_core.accept_landmarks)
        pt_fin, sp_fin, ep_fin = ba_core.accept_landmarks(
            sel, prob,
            _point_chi2(cam, t_new, prob, pt_pos),
            _point_chi2(cam, t_new, prob, pt_new),
            _line_chi2(cam, t_new, prob, ln_sp, ln_ep),
            _line_chi2(cam, t_new, prob, sp_new, ep_new),
            pt_pos, pt_new, ln_sp, sp_new, ln_ep, ep_new)
        return t_new, pt_fin, sp_fin, ep_fin

    def cond(carry):
        _, _, _, _, it, done = carry
        return (it < max_iters) & jnp.logical_not(done)

    def body(carry):
        x, bk, lam, err, it, _ = carry
        cand = solve_with_lam(bk, *x, lam)
        bk_cand, new_err = build_blocks(*cand)
        improve = new_err < err
        # lambda schedule (:1661-1678)
        lam_next = jnp.where(improve, lam / lambda_k, lam * lambda_k)
        x_next = tuple(jnp.where(improve, c, o) for c, o in zip(cand, x))
        bk_next = jax.tree.map(lambda c, o: jnp.where(improve, c, o),
                               bk_cand, bk)
        err_next = jnp.where(improve, new_err, err)
        done = improve & (err - new_err < tol * jnp.maximum(new_err, 1e-12))
        return (x_next, bk_next, lam_next, err_next, it + 1, done)

    bk0, err0 = build_blocks(t_cw0, prob.pt_pos, prob.ln_sp, prob.ln_ep)
    x_fin, _, _, err, iters, _ = jax.lax.while_loop(
        cond, body,
        ((t_cw0, prob.pt_pos, prob.ln_sp, prob.ln_ep), bk0,
         jnp.asarray(lambda0), err0, jnp.asarray(0, jnp.int32),
         jnp.asarray(False)))
    t_cw, pt_pos, ln_sp, ln_ep = x_fin

    # post-BA outlier marking by chi2 (:1714-1836)
    rp, _, _, _ = _point_residuals(cam, t_cw, prob, pt_pos)
    rl, _, _, _, _ = _line_residuals(cam, t_cw, prob, ln_sp, ln_ep)
    po_in = prob.po_valid & (jnp.sum(rp * rp, -1) * prob.po_sigma2 < inlier_chi2)
    lo_in = prob.lo_valid & (jnp.sum(rl * rl, -1) * prob.lo_sigma2 < inlier_chi2)

    kf_pose = jax.vmap(se3.inverse_se3)(t_cw)
    return BAResult(kf_pose=kf_pose, pt_pos=pt_pos, ln_sp=ln_sp, ln_ep=ln_ep,
                    err=err, iters=iters, po_inlier=po_in, lo_inlier=lo_in)


# re-exported for callers that assemble their own reduced systems
_block_diag_embed = ba_core.block_diag_embed
