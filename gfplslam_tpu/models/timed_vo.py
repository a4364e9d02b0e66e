"""Timing-instrumented VO driver: the per-module TimeLog mode.

The reference stamps clock() deltas around each front-end stage and logs 10
per-module times per frame (stereoFrame.cpp:628-629, 765-766,
stereoFrameHandler.cpp:140-145, plslam_mod.cpp:494-513). The production
path fuses the whole front-end into two device programs, so those boundaries
don't exist at runtime; this driver re-expresses the SAME pipeline as one
jitted program per reference stage and synchronizes between them, producing
real per-stage wall times at the cost of fusion (use for diagnosis /
BASELINE comparisons, not peak throughput — ``run_slam --timing``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from gfplslam_tpu.config import Config
from gfplslam_tpu.models import pose_opt
from gfplslam_tpu.models import tracker as trk
from gfplslam_tpu.models.frame import (CameraFeatures, StereoFrame,
                                       describe_line_segments,
                                       detect_line_segments,
                                       detect_point_features,
                                       stereo_match_lines,
                                       stereo_match_points)
from gfplslam_tpu.models.vo import VisualOdometry
from gfplslam_tpu.ops.pyramid import build_pyramid_padded
from gfplslam_tpu.utils import se3
from gfplslam_tpu.utils.timing import StageTimer, TimeLog


@partial(jax.jit, static_argnames=("cfg",))
def _stage_points(cfg: Config, imgs, fast_th):
    """Pyramids + FAST + ORB for both cameras (time_pt_extract)."""
    pyrs = jax.vmap(lambda im: build_pyramid_padded(
        im, cfg.orb.nlevels, cfg.orb.scale_factor))(imgs)
    pts = jax.vmap(lambda im: detect_point_features(im, cfg, fast_th))(imgs)
    return pts, pyrs


@partial(jax.jit, static_argnames=("cfg",))
def _stage_lines(cfg: Config, imgs):
    """LSD-analog detection for both cameras (time_ln_detect)."""
    return jax.vmap(lambda im: detect_line_segments(im, cfg))(imgs)


@jax.jit
def _stage_lbd(imgs, sp, ep):
    """LBD description for both cameras (time_ln_descri)."""
    return jax.vmap(describe_line_segments)(imgs, sp, ep)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_pt_stereo(cfg: Config, feat_l, feat_r, pyr_l, pyr_r):
    return stereo_match_points(cfg.camera, cfg, feat_l, feat_r, pyr_l, pyr_r)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_ln_stereo(cfg: Config, feat_l, feat_r):
    return stereo_match_lines(cfg.camera, cfg, feat_l, feat_r)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_pt_cross(cfg: Config, state, prev, curr):
    dt_pred = se3.inverse_se3(state.dt_store)
    return trk.cross_match_points(cfg, prev, curr, dt_pred)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_ln_cross(cfg: Config, prev, curr):
    return trk.cross_match_lines(cfg, prev, curr)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_linecut(cfg: Config, state, prev, matches):
    dt_pred = se3.inverse_se3(state.dt_store)
    return trk.apply_linecut(cfg, prev, matches, dt_pred)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_pose(cfg: Config, state, matches, opt_lines, delta_t):
    dt_pred = se3.inverse_se3(state.dt_store)
    res = pose_opt.optimize_pose(cfg.camera, dt_pred, matches.points,
                                 opt_lines, cfg.optimizer, delta_t)
    return trk.finalize_track(cfg, state, matches, res)


@dataclass
class TimedVO(VisualOdometry):
    """VisualOdometry with the front-end/tracking hooks replaced by one
    jitted program per reference TimeLog stage. Numerically identical to the
    fused path (same ops, same order); only program boundaries differ."""

    def _frontend(self, img_l, img_r, log: TimeLog,
                  timer: StageTimer, fast_th=None) -> StereoFrame:
        cfg = self.cfg
        imgs = jnp.stack([jnp.asarray(img_l), jnp.asarray(img_r)])

        th = self.state.fast_th if fast_th is None else fast_th
        pts, pyrs = _stage_points(cfg, imgs, th)
        pts[0].block_until_ready()
        log.time_pt_extract = timer.lap()

        lines = _stage_lines(cfg, imgs)
        lines.sp.block_until_ready()
        log.time_ln_detect = timer.lap()

        ln_desc = _stage_lbd(imgs, lines.sp, lines.ep)
        ln_desc.block_until_ready()
        log.time_ln_descri = timer.lap()

        def cam_feats(i):
            return CameraFeatures(
                pt_xy=pts[0][i], pt_level=pts[1][i], pt_angle=pts[2][i],
                pt_desc=pts[3][i], pt_score=pts[4][i], pt_valid=pts[5][i],
                ln_sp=lines.sp[i], ln_ep=lines.ep[i],
                ln_angle=lines.angle[i], ln_desc=ln_desc[i],
                ln_valid=lines.valid[i])

        feat_l, feat_r = cam_feats(0), cam_feats(1)
        stereo_pts = _stage_pt_stereo(cfg, feat_l, feat_r, pyrs[0], pyrs[1])
        stereo_pts.valid.block_until_ready()
        log.time_pt_stereo = timer.lap()

        stereo_lns = _stage_ln_stereo(cfg, feat_l, feat_r)
        stereo_lns.valid.block_until_ready()
        log.time_ln_stereo = timer.lap()

        return StereoFrame(points=stereo_pts, lines=stereo_lns,
                           feat_l=feat_l)

    def _track(self, frame: StereoFrame, delta_t: float, log: TimeLog,
               timer: StageTimer):
        cfg = self.cfg
        pts, pt_idx = _stage_pt_cross(cfg, self.state, self.prev_frame,
                                      frame)
        pts.valid.block_until_ready()
        log.time_pt_cross = timer.lap()

        lns, ln_idx = _stage_ln_cross(cfg, self.prev_frame, frame)
        lns.valid.block_until_ready()
        log.time_ln_cross = timer.lap()

        matches = trk.CrossMatches(points=pts, lines=lns,
                                   pt_curr_idx=pt_idx, ln_curr_idx=ln_idx)
        if cfg.stvo.use_line_conf_cut:
            opt_lines = _stage_linecut(cfg, self.state, self.prev_frame,
                                       matches)
            opt_lines.valid.block_until_ready()
            log.time_ln_cut = timer.lap()
        else:
            opt_lines = matches.lines

        out = _stage_pose(cfg, self.state, matches, opt_lines,
                          jnp.asarray(delta_t, jnp.float32))
        out.pose.dt.block_until_ready()
        log.time_pose_optim = timer.lap()
        return out
