"""Stereo visual-odometry tracker ("StVO") as jitted pure functions.

Capability parity with ``StereoFrameHandler`` (stereoFrameHandler.cpp):
constant-velocity prediction (:153-170), hybrid cross-frame matching
(:451-695), two-stage robust pose optimization (models/pose_opt.py),
pose-entropy keyframe decision (:2309-2380), adaptive FAST threshold + frame
shift (:864-922), and track-loss counting (:2014-2028).

Design: tracker state is a pytree of fixed-shape arrays
(`TrackerState`); one jitted ``track_step`` consumes the previous state and
the current frame's features and returns the new state + diagnostics. Pose
convention: ``t_cam_w`` ("Tfw") maps camera->world, relative pose
``dt_store`` = T_prev<-curr, optimizer works on T_curr<-prev — matching the
reference's composition ``Tfw_curr = Tfw_prev * DT_store``
(stereoFrameHandler.cpp:1984-1996).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gfplslam_tpu.config import Config
from gfplslam_tpu.models import pose_opt
from gfplslam_tpu.models.frame import StereoFrame
from gfplslam_tpu.ops import camera as cam_ops
from gfplslam_tpu.ops.hamming import hamming_matrix
from gfplslam_tpu.ops import matching as match_ops
from gfplslam_tpu.utils import se3
from gfplslam_tpu.utils.robust import masked_stdv_mad_nozero

_LOG_2PI_ENT = 3.0 * (1.0 + jnp.log(2.0 * jnp.pi))  # entropy constant (:2315)


class TrackerState(NamedTuple):
    """Pytree tracker state (StereoFrameHandler members)."""
    t_cam_w: jax.Array          # [4,4] current frame cam->world ("Tfw")
    t_cam_w_cov: jax.Array      # [6,6]
    dt_store: jax.Array         # [4,4] T_prev<-curr of last accepted step
    dt_cov: jax.Array           # [6,6]
    fast_th: jax.Array          # scalar float32 adaptive FAST threshold
    num_frame_loss: jax.Array   # int32 consecutive failed frames
    frames_since_kf: jax.Array  # int32
    entropy_first_prev_kf: jax.Array  # scalar
    cov_prev_kf: jax.Array      # [6,6] accumulated covariance since last KF
    prev_f_is_kf: jax.Array     # bool


class CrossMatches(NamedTuple):
    points: pose_opt.PointMatches
    lines: pose_opt.LineMatches
    # index of the matched current-frame feature per previous-frame slot
    pt_curr_idx: jax.Array  # [Np] int32
    ln_curr_idx: jax.Array  # [Nl] int32


class TrackOutput(NamedTuple):
    state: TrackerState
    pose: pose_opt.PoseResult
    matches: CrossMatches
    need_kf: jax.Array       # bool
    n_inliers_pt: jax.Array  # int32
    n_inliers_ln: jax.Array  # int32
    track_lost: jax.Array    # bool (num_frame_loss exceeded)


def initial_state(cfg: Config) -> TrackerState:
    return TrackerState(
        t_cam_w=jnp.eye(4), t_cam_w_cov=jnp.eye(6),
        dt_store=jnp.eye(4), dt_cov=jnp.zeros((6, 6)),
        fast_th=jnp.asarray(float(cfg.orb.fast_th)),
        num_frame_loss=jnp.asarray(0, jnp.int32),
        frames_since_kf=jnp.asarray(0, jnp.int32),
        entropy_first_prev_kf=jnp.asarray(-1e9),
        cov_prev_kf=jnp.zeros((6, 6)),
        prev_f_is_kf=jnp.asarray(True))


def cross_match_points(cfg: Config, prev: StereoFrame, curr: StereoFrame,
                       dt_pred: jax.Array):
    """Point half of crossFrameMatching_Hybrid (:451-599): Hamming matrix
    gated by search radius + 3D->2D projection window (10 px, :536-540),
    best-per-target dedup, budget."""
    cam, tr, stvo = cfg.camera, cfg.tracking, cfg.stvo
    p = prev.points
    c = curr.points
    d = hamming_matrix(p.desc, c.desc, p.valid, c.valid).astype(jnp.float32)
    # projection of prev 3D points into the predicted current frame
    p_curr = jax.vmap(lambda x: dt_pred[:3, :3] @ x + dt_pred[:3, 3])(p.p3d)
    proj = cam_ops.project_batch(cam, p_curr)
    proj_dist = jnp.linalg.norm(proj[:, None, :] - c.xy[None, :, :], axis=-1)
    radius_dist = jnp.linalg.norm(p.xy[:, None, :] - c.xy[None, :, :], axis=-1)
    gate = (proj_dist <= 10.0) & (radius_dist <= tr.point_match_radius)
    big = jnp.float32(1 << 16)
    dg = jnp.where(gate, d, big)
    i1 = jnp.argmin(dg, axis=1)
    d1 = jnp.take_along_axis(dg, i1[:, None], 1)[:, 0]
    pm = match_ops.Matches(idx=i1, dist=d1, valid=p.valid & (d1 < big))
    pm = match_ops.dedup_per_target(pm, c.xy.shape[0])
    pm = match_ops.budget_gate(pm, stvo.max_point_match_num)
    pts = pose_opt.PointMatches(
        p3d=p.p3d, obs=c.xy[pm.idx], sigma2=p.sigma2, valid=pm.valid)
    pt_curr_idx = jnp.where(pm.valid, pm.idx, -1)
    return pts, pt_curr_idx


def cross_match_lines(cfg: Config, prev: StereoFrame, curr: StereoFrame):
    """Line half of crossFrameMatching_Hybrid (:605-686): mutual best +
    distinctiveness (MAD) + budget-distance threshold."""
    tr, stvo = cfg.tracking, cfg.stvo
    lp = prev.lines
    lc = curr.lines
    dl = hamming_matrix(lp.desc, lc.desc, lp.valid, lc.valid).astype(jnp.float32)
    lm = match_ops.mutual_best(dl)
    dl1 = jnp.min(dl, axis=1)
    dl2 = jnp.min(jnp.where(dl <= dl1[:, None], jnp.inf, dl), axis=1)
    # exact-tie minima give gap 0 (knnMatch's dist_12 includes ties,
    # stereoFrame.cpp:681) so ambiguous matches fail the distinctiveness gate
    tie = jnp.sum(dl == dl1[:, None], axis=1) > 1
    gap = jnp.where(tie | ~jnp.isfinite(dl2), 0.0, dl2 - dl1)
    gap_th = masked_stdv_mad_nozero(gap, lm.valid) * tr.desc_th_l
    lm = lm._replace(valid=lm.valid & (gap > gap_th))
    # budget-distance threshold (keep dist <= 1.2 * K-th best) + hard cap
    # (lineDescriptorBudgetThres + gate at :654-659, :678-683)
    lm = match_ops.budget_gate(lm, stvo.max_line_match_num)
    lns = pose_opt.LineMatches(
        sp3d=lp.sp3d, ep3d=lp.ep3d, le_obs=lc.le[lm.idx],
        sigma2=lp.sigma2, valid=lm.valid)
    ln_curr_idx = jnp.where(lm.valid, lm.idx, -1)
    return lns, ln_curr_idx


def cross_frame_matching(cfg: Config, prev: StereoFrame, curr: StereoFrame,
                         dt_pred: jax.Array) -> CrossMatches:
    """Hybrid cross-frame matching (crossFrameMatching_Hybrid, :451-695):
    the point and line halves above, fused into one program.
    ``dt_pred`` is the constant-velocity T_curr<-prev used for projection.
    """
    pts, pt_curr_idx = cross_match_points(cfg, prev, curr, dt_pred)
    lns, ln_curr_idx = cross_match_lines(cfg, prev, curr)
    return CrossMatches(points=pts, lines=lns,
                        pt_curr_idx=pt_curr_idx, ln_curr_idx=ln_curr_idx)


def _entropy(cov: jax.Array) -> jax.Array:
    """Pose entropy 3(1+log 2pi) + 0.5 log det(cov) (:2314-2329)."""
    sign, logdet = jnp.linalg.slogdet(cov)
    return _LOG_2PI_ENT + 0.5 * jnp.where(sign > 0, logdet, jnp.nan)


def _update_fast_th(cfg: Config, fast_th, accepted, err, n_pt, n_all):
    """Adaptive FAST threshold schedule (updateFrame_ECCV18, :868-888)."""
    tr = cfg.tracking
    lo, hi = float(tr.fast_min_th), float(tr.fast_max_th)
    inc = float(tr.fast_inc_th)
    feat = tr.fast_feat_th
    bad = jnp.logical_not(accepted) | (err > tr.fast_err_th)
    th = jnp.where(
        bad, jnp.maximum(lo, fast_th - 2 * inc),
        jnp.where(n_pt < feat, jnp.maximum(lo, fast_th - 2 * inc),
        jnp.where(n_all < feat * 2, jnp.maximum(lo, fast_th - inc),
        jnp.where(n_all > feat * 4, jnp.minimum(hi, fast_th + 2 * inc),
        jnp.where(n_all > feat * 3, jnp.minimum(hi, fast_th + inc),
                  fast_th)))))
    return th


def apply_linecut(cfg: Config, prev: StereoFrame, matches: CrossMatches,
                  dt_pred: jax.Array):
    """Good-line-cutting preconditioner on the matched lines, applied before
    pose optimization (insertStereoPair :103-146 ordering)."""
    from gfplslam_tpu.models import linecut
    from gfplslam_tpu.models.frame import estimate_line_uncertainty
    prev_lines = estimate_line_uncertainty(cfg.camera, cfg, prev.lines)
    cut = linecut.cut_lines(cfg.camera, dt_pred, matches.lines,
                            prev_lines.cov_sp3d, prev_lines.cov_ep3d,
                            matches.points,
                            use_logdet=cfg.stvo.max_vol_line_cut)
    return linecut.apply_cut(cfg.camera, matches.lines, cut)


@partial(jax.jit, static_argnames=("cfg",))
def track_step(cfg: Config, state: TrackerState, prev: StereoFrame,
               curr: StereoFrame, delta_t: jax.Array) -> TrackOutput:
    """One tracking iteration: predict, match, optimize, decide KF.

    Mirrors the per-frame sequence insertStereoPair -> optimizePose ->
    needNewKF (stereoFrameHandler.cpp:83-151, 1939-2030, 2309-2349).
    """
    # constant-velocity prediction: T_curr<-prev ~= inv(dt_store)
    dt_pred = se3.inverse_se3(state.dt_store)
    matches = cross_frame_matching(cfg, prev, curr, dt_pred)

    opt_lines = (apply_linecut(cfg, prev, matches, dt_pred)
                 if cfg.stvo.use_line_conf_cut and cfg.stvo.has_lines
                 else matches.lines)

    res = pose_opt.optimize_pose(cfg.camera, dt_pred, matches.points,
                                 opt_lines, cfg.optimizer, delta_t)
    return finalize_track(cfg, state, matches, res)


def finalize_track(cfg: Config, state: TrackerState, matches: CrossMatches,
                   res) -> TrackOutput:
    """Post-optimization state update + KF decision (the tail of the
    per-frame sequence: :1984-2030, needNewKF :2309-2349,
    updateFrame_ECCV18 :864-922)."""
    dt_store = se3.inverse_se3(res.dt)           # T_prev<-curr
    t_cam_w = state.t_cam_w @ dt_store           # Tfw composition (:1996)
    t_cam_w = jnp.where(res.accepted, t_cam_w, state.t_cam_w)
    t_cov = jnp.where(res.accepted,
                      se3.transport_cov_se3(state.t_cam_w, res.dt_cov)
                      + state.t_cam_w_cov,
                      state.t_cam_w_cov)
    num_loss = jnp.where(res.accepted, 0, state.num_frame_loss + 1)

    # ---- KF decision (needNewKF, :2309-2348) ----
    ent_first = jnp.where(state.prev_f_is_kf, _entropy(res.dt_cov),
                          state.entropy_first_prev_kf)
    cov_step = se3.transport_cov_se3(se3.inverse_se3(dt_store), res.dt_cov)
    cov_acc = state.cov_prev_kf + cov_step
    ent_ratio = _entropy(cov_acc) / ent_first
    frames_since = state.frames_since_kf + 1
    need_kf = ((frames_since > cfg.slam.max_kf_num_frames)
               | (ent_ratio < cfg.slam.min_entropy_ratio)
               | jnp.isnan(ent_ratio) | jnp.isinf(ent_ratio)
               | jnp.logical_not(res.accepted))

    n_pt = jnp.sum(res.pt_inlier)
    n_ln = jnp.sum(res.ln_inlier)
    fast_th = _update_fast_th(cfg, state.fast_th, res.accepted, res.err,
                              n_pt, n_pt + n_ln)

    new_state = TrackerState(
        t_cam_w=t_cam_w, t_cam_w_cov=t_cov, dt_store=dt_store,
        dt_cov=res.dt_cov, fast_th=fast_th, num_frame_loss=num_loss,
        frames_since_kf=frames_since, entropy_first_prev_kf=ent_first,
        cov_prev_kf=cov_acc, prev_f_is_kf=jnp.asarray(False))
    return TrackOutput(
        state=new_state, pose=res, matches=matches, need_kf=need_kf,
        n_inliers_pt=n_pt, n_inliers_ln=n_ln,
        track_lost=num_loss > cfg.slam.max_num_frame_loss)


def mark_keyframe(state: TrackerState) -> TrackerState:
    """Reset relative-pose bookkeeping at a new keyframe
    (currFrameIsKF, :2351-2380): poses restart relative to the KF."""
    return state._replace(
        t_cam_w=jnp.eye(4), t_cam_w_cov=jnp.eye(6),
        frames_since_kf=jnp.asarray(0, jnp.int32),
        cov_prev_kf=jnp.zeros((6, 6)),
        prev_f_is_kf=jnp.asarray(True))
