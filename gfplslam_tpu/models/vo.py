"""Host-side visual-odometry driver: the tiny sequential loop around the
jitted per-frame programs.

Role parity with the `plstvo` apps + StereoFrameHandler's frame shifting
(app/plstvo_mod.cpp:249-318, stereoFrameHandler.cpp:83-151, 864-922): feed
rectified stereo pairs, collect per-frame poses, timing, and keyframe
signals. The device does all compute in two programs per frame
(front-end `process_stereo_pair`, tracking `track_step`); the host only
shifts pytrees and logs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gfplslam_tpu.config import Config
from gfplslam_tpu.models import tracker as trk
from gfplslam_tpu.models.frame import StereoFrame, process_stereo_pair
from gfplslam_tpu.utils.timing import StageTimer, TimeLog, TimeLogWriter


@partial(jax.jit, static_argnames=("cfg",))
def run_vo_scan(cfg: Config, imgs_l, imgs_r, timestamps):
    """Whole-sequence visual odometry as ONE device program.

    ``lax.scan`` over frames: per step the front-end + tracker run on-device
    with zero host round-trips; the trajectory comes back as a single array.
    This is the throughput path (the host-driven ``VisualOdometry`` below
    exists for interactive/driver use and SLAM-back-end interleaving).

    Args: imgs_l/imgs_r [T, H, W] float32 (rectified), timestamps [T].
    Returns (poses [T, 4, 4] absolute cam->world, aux dict of per-frame
    diagnostics).
    """
    import jax
    import jax.numpy as jnp
    from gfplslam_tpu.models.frame import process_stereo_pair
    from gfplslam_tpu.models.tracker import (initial_state, mark_keyframe,
                                             track_step)

    def step(carry, inputs):
        st, prev_frame, prev_ts, t_abs = carry
        img_l, img_r, ts = inputs
        frame = process_stereo_pair(img_l, img_r, cfg, st.fast_th)
        out = track_step(cfg, st, prev_frame, frame,
                         jnp.maximum(ts - prev_ts, 1e-3))
        t_abs_new = t_abs @ out.state.dt_store
        # KF bookkeeping reset (currFrameIsKF) without touching t_abs
        st_kf = mark_keyframe(out.state)
        st_next = jax.tree.map(
            lambda a, b: jnp.where(out.need_kf, a, b), st_kf, out.state)
        aux = dict(accepted=out.pose.accepted, n_pt=out.n_inliers_pt,
                   n_ln=out.n_inliers_ln, is_kf=out.need_kf,
                   err=out.pose.err)
        return (st_next, frame, ts, t_abs_new), (t_abs_new, aux)

    st0 = initial_state(cfg)
    # frame-0 bootstrap detects at the FAST floor: the map/tracker is seeded
    # from this one frame, so it gets the loosest gate (the analog of the
    # reference's dedicated looser-gated extractInitialStereoFeatures,
    # stereoFrame.cpp:148-336, called only from initialize())
    frame0 = process_stereo_pair(
        imgs_l[0], imgs_r[0], cfg,
        jnp.asarray(float(cfg.tracking.fast_min_th)))
    carry0 = (st0, frame0, timestamps[0], jnp.eye(4))
    _, (poses, aux) = jax.lax.scan(
        step, carry0, (imgs_l[1:], imgs_r[1:], timestamps[1:]))
    poses = jnp.concatenate([jnp.eye(4)[None], poses])
    return poses, aux


@partial(jax.jit, static_argnames=("cfg",))
def run_vo_scan_chunk(cfg: Config, carry, imgs_l, imgs_r, timestamps):
    """One CHUNK of the whole-sequence scan, with tracker carry in/out —
    the scan-throughput path packaged for the streaming SLAM driver
    (``SLAMSystem.process_chunk``): tracking for N frames costs ONE
    dispatch, and the per-frame detected features come back stacked on
    device so keyframe mapping can slice them without re-running the
    front-end.

    Args: carry from :func:`init_scan_carry` or a previous chunk;
    imgs [T, H, W]; timestamps [T].
    Returns (carry', poses [T, 4, 4] absolute VO cam->world, aux dict,
    frames — the per-frame StereoFrame pytree with leading T axis)."""
    from gfplslam_tpu.models.tracker import mark_keyframe, track_step

    def step(c, inputs):
        st, prev_frame, prev_ts, t_abs = c
        img_l, img_r, ts = inputs
        frame = process_stereo_pair(img_l, img_r, cfg, st.fast_th)
        out = track_step(cfg, st, prev_frame, frame,
                         jnp.maximum(ts - prev_ts, 1e-3))
        t_abs_new = t_abs @ out.state.dt_store
        st_kf = mark_keyframe(out.state)
        st_next = jax.tree.map(
            lambda a, b: jnp.where(out.need_kf, a, b), st_kf, out.state)
        aux = dict(accepted=out.pose.accepted, n_pt=out.n_inliers_pt,
                   n_ln=out.n_inliers_ln, is_kf=out.need_kf,
                   lost=out.track_lost)
        return (st_next, frame, ts, t_abs_new), (t_abs_new, aux, frame)

    carry_out, (poses, aux, frames) = jax.lax.scan(
        step, carry, (imgs_l, imgs_r, timestamps))
    return carry_out, poses, aux, frames


@partial(jax.jit, static_argnames=("cfg",))
def init_scan_carry(cfg: Config, img_l, img_r, timestamp):
    """Frame-0 carry for :func:`run_vo_scan_chunk` (frame 0 is the first
    keyframe; its features come back for map initialization). Detection
    runs at the FAST floor threshold — the bootstrap-frame analog of the
    reference's looser-gated extractInitialStereoFeatures
    (stereoFrame.cpp:148-336)."""
    st0 = trk.initial_state(cfg)
    frame0 = process_stereo_pair(
        img_l, img_r, cfg, jnp.asarray(float(cfg.tracking.fast_min_th)))
    return (st0, frame0, jnp.asarray(timestamp, jnp.float32),
            jnp.eye(4)), frame0


@partial(jax.jit, static_argnames=("cfg",))
def pack_chunk_aux(cfg: Config, poses, aux):
    """[T, 21] float32: per-frame (is_kf, accepted, lost, n_pt, n_ln,
    flattened 4x4 pose) — the chunk's ONE device->host transfer."""
    t = poses.shape[0]
    return jnp.concatenate([
        jnp.stack([aux["is_kf"], aux["accepted"], aux["lost"],
                   aux["n_pt"], aux["n_ln"]], axis=1).astype(jnp.float32),
        poses.reshape(t, 16).astype(jnp.float32)], axis=1)


@jax.jit
def _pack2(pt_valid, ln_valid):
    """Frame-0 scalar pack: one array, one transfer."""
    return jnp.stack([jnp.sum(pt_valid), jnp.sum(ln_valid)]
                     ).astype(jnp.float32)


@jax.jit
def _pack_frame_scalars(pt_valid, ln_valid, n_pt_x, n_ln_x, need_kf,
                        t_cam_w, accepted, lost):
    """All of one frame's host-visible scalars as ONE [23] float32 array so
    the driver pays a single device->host round trip per frame (see
    ``VisualOdometry.process``)."""
    return jnp.concatenate([
        jnp.stack([jnp.sum(pt_valid), jnp.sum(ln_valid),
                   n_pt_x, n_ln_x]).astype(jnp.float32),
        jnp.stack([need_kf, accepted, lost]).astype(jnp.float32),
        t_cam_w.reshape(-1).astype(jnp.float32),
    ])


@dataclass
class FrameRecord:
    timestamp: float
    t_cam_w: np.ndarray      # absolute cam->world (world = first KF frame)
    is_kf: bool
    n_pt: int
    n_ln: int
    accepted: bool
    # pose relative to the base keyframe, and which KF that is — these let
    # the SLAM layer re-express every frame on the *optimized* map KF poses
    # (the reference writes trajectories from T_base_kf * DT, see
    # plslam_mod.cpp:471-493 + mapHandler KF poses)
    base_kf: int = 0
    t_rel_base: np.ndarray = None


@dataclass
class VisualOdometry:
    cfg: Config
    state: Optional[trk.TrackerState] = None
    prev_frame: Optional[StereoFrame] = None
    prev_time: float = 0.0
    t_base_w: np.ndarray = field(default_factory=lambda: np.eye(4))
    records: List[FrameRecord] = field(default_factory=list)
    timelog: TimeLogWriter = field(default_factory=TimeLogWriter)
    frame_idx: int = 0
    lost: bool = False
    kf_count: int = 0
    # VO-only relative motion KF_{k-1} -> KF_k captured at the latest KF
    # decision (the reference's T_rel handed to MapHandler::addKeyFrame,
    # mapHandler.cpp:126-128 — pure odometry, independent of any map
    # correction)
    last_kf_rel: Optional[np.ndarray] = None

    def rebase(self, t_base_w: np.ndarray) -> None:
        """Re-base the tracker's absolute frame onto a corrected base-KF pose
        (the back-end feeds BA/PGO corrections forward so subsequent frames
        ride the optimized map, mirroring the reference's use of the map KF
        pose as T_base in updateFrame_ECCV18, plslam_mod.cpp:471-477)."""
        self.t_base_w = np.asarray(t_base_w, np.float64).copy()

    def _frontend(self, img_l, img_r, log: TimeLog,
                  timer: StageTimer, fast_th=None) -> StereoFrame:
        """Front-end hook: one fused device program, dispatched WITHOUT a
        host sync (production path — every device->host round trip stalls
        the host, so the driver reads all of a frame's host-visible scalars
        in one batched transfer at the end of ``process``). TimedVO overrides with staged+blocking programs for
        real per-stage TimeLog rows. ``fast_th`` overrides the adaptive
        threshold (the frame-0 bootstrap passes the FAST floor)."""
        th = self.state.fast_th if fast_th is None else fast_th
        frame = process_stereo_pair(jnp.asarray(img_l), jnp.asarray(img_r),
                                    self.cfg, th)
        log.time_pt_extract = timer.lap()
        return frame

    def _track(self, frame: StereoFrame, delta_t: float, log: TimeLog,
               timer: StageTimer):
        """Tracking hook: fused track_step, dispatched without a sync."""
        out = trk.track_step(self.cfg, self.state, self.prev_frame, frame,
                             jnp.asarray(delta_t, jnp.float32))
        log.time_pose_optim = timer.lap()
        return out

    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                timestamp: float) -> FrameRecord:
        """One camera frame. Returns this frame's record."""
        timer = StageTimer()
        log = TimeLog()
        if self.state is None:
            self.state = trk.initial_state(self.cfg)
        # frame-0 bootstrap detects at the FAST floor (the analog of the
        # reference's looser-gated extractInitialStereoFeatures,
        # stereoFrame.cpp:148-336, used only by initialize())
        boot_th = (jnp.asarray(float(self.cfg.tracking.fast_min_th))
                   if self.prev_frame is None else None)
        frame = self._frontend(img_l, img_r, log, timer, fast_th=boot_th)

        if self.prev_frame is None:
            # frame 0: initialize (StVO->initialize, plslam_mod.cpp:375-381)
            n_pt0, n_ln0 = np.asarray(_pack2(frame.points.valid,
                                             frame.lines.valid))
            log.num_pt_stereo = int(n_pt0)
            log.num_ln_stereo = int(n_ln0)
            self.prev_frame = frame
            self.prev_time = timestamp
            self.kf_count = 1
            self.last_kf_rel = np.eye(4)
            rec = FrameRecord(timestamp, self.t_base_w.copy(), True,
                              log.num_pt_stereo, log.num_ln_stereo, True,
                              base_kf=0, t_rel_base=np.eye(4))
            self.records.append(rec)
            self.timelog.append(log)
            self.frame_idx += 1
            return rec

        delta_t = max(timestamp - self.prev_time, 1e-3)
        out = self._track(frame, delta_t, log, timer)

        # ONE device array, ONE device->host transfer for every host-
        # visible scalar of this frame: each separate int()/bool()/
        # asarray() — and each leaf of a device_get tuple — is a full
        # device->host round trip
        packed = np.asarray(_pack_frame_scalars(
            frame.points.valid, frame.lines.valid, out.n_inliers_pt,
            out.n_inliers_ln, out.need_kf, out.state.t_cam_w,
            out.pose.accepted, out.track_lost))
        n_pt_st, n_ln_st, n_pt_x, n_ln_x = packed[:4]
        need_kf_d, accepted_d, lost_d = packed[4:7] > 0.5
        t_cam_w_d = packed[7:23].reshape(4, 4).astype(np.float64)
        log.num_pt_stereo = int(n_pt_st)
        log.num_ln_stereo = int(n_ln_st)
        log.num_pt_cross = int(n_pt_x)
        log.num_ln_cross = int(n_ln_x)
        log.time_track = sum(getattr(log, f) for f in (
            "time_pt_extract", "time_ln_detect", "time_ln_descri",
            "time_pt_stereo", "time_ln_stereo", "time_pt_cross",
            "time_ln_cross", "time_ln_cut", "time_pose_optim"))

        self.state = out.state
        need_kf = bool(need_kf_d)
        t_rel = np.asarray(t_cam_w_d)
        if need_kf:
            # absolute pose base moves to this KF (updateFrame_ECCV18 +
            # currFrameIsKF composition); keep the raw VO relative motion
            # for the map layer's pose composition
            self.last_kf_rel = t_rel.copy()
            self.t_base_w = self.t_base_w @ t_rel
            self.state = trk.mark_keyframe(out.state)
            t_abs = self.t_base_w.copy()
            base_kf = self.kf_count
            t_rel_base = np.eye(4)
            self.kf_count += 1
        else:
            t_abs = self.t_base_w @ t_rel
            base_kf = self.kf_count - 1
            t_rel_base = t_rel
        self.lost = self.lost or bool(lost_d)

        self.prev_frame = frame
        self.prev_time = timestamp
        rec = FrameRecord(timestamp, t_abs, need_kf,
                          int(n_pt_x), int(n_ln_x), bool(accepted_d),
                          base_kf=base_kf, t_rel_base=t_rel_base)
        self.records.append(rec)
        self.timelog.append(log)
        self.frame_idx += 1
        return rec

    @property
    def trajectory(self) -> np.ndarray:
        return np.stack([r.t_cam_w for r in self.records])

    @property
    def timestamps(self) -> np.ndarray:
        return np.asarray([r.timestamp for r in self.records])
