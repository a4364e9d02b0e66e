"""SLAM map back-end: keyframes, landmark pools, covisibility, BA windows.

Capability parity with ``MapHandler``'s data layer (mapHandler.cpp): KF
insertion + pose composition (:113-187), KF<->map data association
(``lookForCommonMatches``, :189-772), covisibility ``full_graph`` expansion
(:774-787), local-map formation (:789-857), landmark culling
(``removeBadMapLandmarks``, :2550-2630), plus the observation bookkeeping
that feeds local BA (obs lists, :1143-1161).

Design: the reference's pointer graph (KeyFrame*/MapPoint*/
MapLine* with std::vector obs lists, keyFrame.h:60-70, mapFeatures.h:40-95)
becomes one `MapState` pytree of fixed-capacity arrays — landmark pools,
flat observation tables (ring allocation), and a dense [K, K] covisibility
count matrix. Data association is one masked Hamming matrix against local
landmarks instead of per-feature BFMatcher loops; the reference's separate
prev-KF and local-map matching stages collapse into the local-map stage
(every prev-KF feature is itself a landmark here, so coverage is a superset).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gfplslam_tpu.config import Config
from gfplslam_tpu.models.ba import BAProblem
from gfplslam_tpu.models.frame import StereoFrame
from gfplslam_tpu.ops import camera as cam_ops
from gfplslam_tpu.ops.hamming import hamming_matrix
from gfplslam_tpu.ops import matching as match_ops
from gfplslam_tpu.utils import se3

CHI2_2DOF = 7.815  # 95% gate used throughout the reference (:265, :403)
DESC_HIST = 4      # recent observations kept per landmark for the medoid
# descriptor-distance caps on landmark association (the reference gates both
# families on descriptor thresholds, mapHandler.cpp:265/631-771): a
# geometrically-plausible but wrong feature must not attach to a landmark
# with an arbitrarily bad descriptor. 256-bit ORB/LBD; lines are slightly
# less distinctive so their cap is looser.
MAX_HAMMING_PT = 80
MAX_HAMMING_LN = 96


class MapState(NamedTuple):
    # keyframes
    kf_pose: jax.Array      # [K, 4, 4] cam->world
    kf_valid: jax.Array     # [K] bool
    n_kf: jax.Array         # int32
    # point landmarks (MapPoint, mapFeatures.h:40-70)
    pt_pos: jax.Array       # [P, 3] world
    pt_desc: jax.Array      # [P, 8] uint32 representative (medoid) descriptor
    pt_desc_hist: jax.Array  # [P, DESC_HIST, 8] uint32 recent-obs ring
    pt_obs_n: jax.Array     # [P] int32 observation count
    pt_last_kf: jax.Array   # [P] int32 last observing KF
    pt_valid: jax.Array     # [P] bool
    # line landmarks (MapLine, mapFeatures.h:72-95)
    ln_sp: jax.Array        # [L, 3]
    ln_ep: jax.Array        # [L, 3]
    ln_desc: jax.Array      # [L, 8] uint32
    ln_desc_hist: jax.Array  # [L, DESC_HIST, 8] uint32
    ln_obs_n: jax.Array     # [L]
    ln_last_kf: jax.Array   # [L]
    ln_valid: jax.Array     # [L] bool
    # observation tables (flat, ring-allocated)
    po_kf: jax.Array        # [Op] int32
    po_lm: jax.Array        # [Op] int32
    po_uv: jax.Array        # [Op, 2]
    po_sigma2: jax.Array    # [Op]
    po_valid: jax.Array     # [Op] bool
    po_head: jax.Array      # int32 next free slot
    lo_kf: jax.Array        # [Ol]
    lo_lm: jax.Array        # [Ol]
    lo_le: jax.Array        # [Ol, 3]
    lo_sigma2: jax.Array    # [Ol]
    lo_valid: jax.Array     # [Ol] bool
    lo_head: jax.Array      # int32
    # covisibility counts (full_graph, mapHandler.h:135)
    full_graph: jax.Array   # [K, K] int32


def empty_map(cfg: Config) -> MapState:
    cap = cfg.cap
    k, p, l = cap.n_kf_max, cap.n_map_pt, cap.n_map_ln
    op, ol = cap.n_obs_pt * 16, cap.n_obs_ln * 16
    return MapState(
        kf_pose=jnp.tile(jnp.eye(4)[None], (k, 1, 1)),
        kf_valid=jnp.zeros(k, bool), n_kf=jnp.asarray(0, jnp.int32),
        pt_pos=jnp.zeros((p, 3)), pt_desc=jnp.zeros((p, 8), jnp.uint32),
        pt_desc_hist=jnp.zeros((p, DESC_HIST, 8), jnp.uint32),
        pt_obs_n=jnp.zeros(p, jnp.int32), pt_last_kf=jnp.zeros(p, jnp.int32),
        pt_valid=jnp.zeros(p, bool),
        ln_sp=jnp.zeros((l, 3)), ln_ep=jnp.zeros((l, 3)),
        ln_desc=jnp.zeros((l, 8), jnp.uint32),
        ln_desc_hist=jnp.zeros((l, DESC_HIST, 8), jnp.uint32),
        ln_obs_n=jnp.zeros(l, jnp.int32), ln_last_kf=jnp.zeros(l, jnp.int32),
        ln_valid=jnp.zeros(l, bool),
        po_kf=jnp.zeros(op, jnp.int32), po_lm=jnp.zeros(op, jnp.int32),
        po_uv=jnp.zeros((op, 2)), po_sigma2=jnp.ones(op),
        po_valid=jnp.zeros(op, bool), po_head=jnp.asarray(0, jnp.int32),
        lo_kf=jnp.zeros(ol, jnp.int32), lo_lm=jnp.zeros(ol, jnp.int32),
        lo_le=jnp.zeros((ol, 3)), lo_sigma2=jnp.ones(ol),
        lo_valid=jnp.zeros(ol, bool), lo_head=jnp.asarray(0, jnp.int32),
        full_graph=jnp.zeros((k, k), jnp.int32),
    )


def _update_desc_medoid(hist, rep, obs_n, lm_safe, obs_mask, new_desc):
    """Representative-descriptor refresh via a DESC_HIST-deep ring of recent
    observations + medoid selection (total-Hamming-distance minimizer over
    the buffer). Approximates the reference's median-distance medoid over
    the full obs list (updateAverageDescDir, mapFeatures.cpp:50-107) at O(1)
    memory per landmark; unlike a newest-wins update, one blurred/occluded
    observation cannot poison the landmark's descriptor.

    ``obs_n`` must be the PRE-update observation count; ``lm_safe`` the
    in-range landmark id per feature; ``obs_mask`` which features observed a
    landmark this KF. Returns (hist, rep) updated."""
    p = hist.shape[0]
    b = hist.shape[1]
    cnt = obs_n[lm_safe]                      # [N] obs before this one
    pos = cnt % b
    dst = jnp.where(obs_mask, lm_safe * b + pos, p * b)
    hist = hist.reshape(p * b, -1).at[dst].set(new_desc, mode="drop")
    hist = hist.reshape(p, b, -1)

    buf = hist[lm_safe]                       # [N, B, 8]
    occ = jnp.minimum(cnt + 1, b)             # occupied slots 0..occ-1
    slot_ok = jnp.arange(b)[None, :] < occ[:, None]          # [N, B]
    x = jnp.bitwise_xor(buf[:, :, None, :], buf[:, None, :, :])
    dist = jnp.sum(jax.lax.population_count(x), axis=-1)      # [N, B, B]
    sumd = jnp.sum(jnp.where(slot_ok[:, None, :], dist, 0), axis=2)
    score = jnp.where(slot_ok, sumd, jnp.iinfo(jnp.int32).max)
    sel = jnp.argmin(score, axis=1)                           # [N]
    medoid = jnp.take_along_axis(buf, sel[:, None, None].astype(jnp.int32)
                                 .repeat(buf.shape[-1], -1), axis=1)[:, 0]
    rep = rep.at[jnp.where(obs_mask, lm_safe, p)].set(medoid, mode="drop")
    return hist, rep


def _alloc_slots(free_mask: jax.Array, want: jax.Array) -> jax.Array:
    """For each True in ``want`` (feature creates a landmark), assign a free
    pool slot; -1 if the pool is exhausted. Returns [len(want)] int32."""
    free_idx = jnp.where(free_mask, jnp.arange(free_mask.shape[0]),
                         free_mask.shape[0])
    free_sorted = jnp.sort(free_idx)  # free slots first
    rank = jnp.cumsum(want.astype(jnp.int32)) - 1
    n_free = jnp.sum(free_mask)
    slot = jnp.where(want & (rank < n_free) & (rank < free_sorted.shape[0]),
                     free_sorted[jnp.clip(rank, 0, free_sorted.shape[0] - 1)],
                     -1)
    return slot


def _append_obs(kf_arr, lm_arr, uv_arr, s2_arr, valid_arr, head,
                kf_idx, lm_idx, uv, s2, want):
    """Ring-append a batch of observations at ``head`` (wraps around,
    overwriting the oldest entries — the flat analog of obs lists)."""
    cap = kf_arr.shape[0]
    rank = jnp.cumsum(want.astype(jnp.int32)) - 1
    pos = (head + rank) % cap
    idx = jnp.where(want, pos, cap)  # out-of-range writes dropped
    kf_arr = kf_arr.at[idx].set(jnp.full_like(lm_idx, kf_idx), mode="drop")
    lm_arr = lm_arr.at[idx].set(lm_idx, mode="drop")
    uv_arr = uv_arr.at[idx].set(uv, mode="drop")
    s2_arr = s2_arr.at[idx].set(s2, mode="drop")
    valid_arr = valid_arr.at[idx].set(True, mode="drop")
    n_new = jnp.sum(want)
    return kf_arr, lm_arr, uv_arr, s2_arr, valid_arr, (head + n_new) % cap


class KFMatchResult(NamedTuple):
    pt_lm_idx: jax.Array  # [Np] landmark id per frame point (-1 = none)
    ln_lm_idx: jax.Array  # [Nl]
    n_pt_matched: jax.Array
    n_ln_matched: jax.Array


def _match_frame_to_map(cfg: Config, m: MapState, frame: StereoFrame,
                        t_kf_w: jax.Array, local_pt: jax.Array,
                        local_ln: jax.Array) -> KFMatchResult:
    """Descriptor + chi2-projection association of new-KF features to local
    landmarks (lookForCommonMatches, mapHandler.cpp:189-772)."""
    cam = cfg.camera
    t_cw = se3.inverse_se3(t_kf_w)

    # ---- points ----
    f = frame.points
    d = hamming_matrix(f.desc, m.pt_desc, f.valid,
                       m.pt_valid & local_pt).astype(jnp.float32)
    proj = cam_ops.project_batch(
        cam, jax.vmap(lambda x: t_cw[:3, :3] @ x + t_cw[:3, 3])(m.pt_pos))
    pd = jnp.linalg.norm(f.xy[:, None, :] - proj[None, :, :], axis=-1)
    big = jnp.float32(1 << 16)
    # chi2(0.95, 2dof) gate on the SIGMA-NORMALIZED reprojection distance
    # (mapHandler.cpp:265 applies sqrt(7.815) to best_d_sigma): f.sigma2 is
    # the per-octave inverse variance, so higher-octave (blurrier) features
    # pass at the same confidence as level-0 instead of being over-rejected.
    d = jnp.where(pd * pd * f.sigma2[:, None] < CHI2_2DOF, d, big)
    mm = match_ops.Matches(
        idx=jnp.argmin(d, 1),
        dist=jnp.min(d, 1),
        valid=f.valid & (jnp.min(d, 1) < big))
    mm = mm._replace(valid=mm.valid & (mm.dist < MAX_HAMMING_PT))
    mm = match_ops.dedup_per_target(mm, m.pt_pos.shape[0])
    pt_lm = jnp.where(mm.valid, mm.idx, -1)

    # ---- lines: descriptor + endpoint-to-projected-line distance gate ----
    fl = frame.lines
    dl = hamming_matrix(fl.desc, m.ln_desc, fl.valid,
                        m.ln_valid & local_ln).astype(jnp.float32)
    sp_c = jax.vmap(lambda x: t_cw[:3, :3] @ x + t_cw[:3, 3])(m.ln_sp)
    ep_c = jax.vmap(lambda x: t_cw[:3, :3] @ x + t_cw[:3, 3])(m.ln_ep)
    sp2 = cam_ops.project_batch(cam, sp_c)
    ep2 = cam_ops.project_batch(cam, ep_c)
    # distance of projected endpoints to the observed frame line
    def pt_line_d(p, le):
        return jnp.abs(le[0] * p[0] + le[1] * p[1] + le[2])
    dist_s = jax.vmap(lambda le: jax.vmap(lambda p: pt_line_d(p, le))(sp2))(fl.le)
    dist_e = jax.vmap(lambda le: jax.vmap(lambda p: pt_line_d(p, le))(ep2))(fl.le)
    # sigma-normalized two-endpoint gate (mapHandler.cpp:403: the line
    # residual is the endpoint-to-line distance pair, chi2 with 2 dof per
    # endpoint)
    geom_ok = ((dist_s * dist_s + dist_e * dist_e) * fl.sigma2[:, None]
               < 2 * CHI2_2DOF)
    dl = jnp.where(geom_ok, dl, big)
    lm_m = match_ops.Matches(
        idx=jnp.argmin(dl, 1), dist=jnp.min(dl, 1),
        valid=fl.valid & (jnp.min(dl, 1) < big))
    lm_m = lm_m._replace(valid=lm_m.valid & (lm_m.dist < MAX_HAMMING_LN))
    lm_m = match_ops.dedup_per_target(lm_m, m.ln_sp.shape[0])
    ln_lm = jnp.where(lm_m.valid, lm_m.idx, -1)

    return KFMatchResult(pt_lm_idx=pt_lm, ln_lm_idx=ln_lm,
                         n_pt_matched=jnp.sum(pt_lm >= 0),
                         n_ln_matched=jnp.sum(ln_lm >= 0))


def local_kf_mask(cfg: Config, m: MapState, kf_idx: jax.Array) -> jax.Array:
    """Local-map KFs: covisibility >= min_lm_cov_graph with the given KF, or
    among the last min_kf_local_map KFs (formLocalMap, :789-857)."""
    k = m.kf_pose.shape[0]
    ids = jnp.arange(k)
    covis = m.full_graph[kf_idx] + m.full_graph[:, kf_idx]
    recent = (ids <= kf_idx) & (ids > kf_idx - cfg.slam.min_kf_local_map - 1)
    return m.kf_valid & ((covis >= cfg.slam.min_lm_cov_graph) | recent)


def local_landmark_masks(cfg: Config, m: MapState, kf_idx: jax.Array
                         ) -> tuple[jax.Array, jax.Array]:
    """Landmarks observed by any local KF."""
    kf_loc = local_kf_mask(cfg, m, kf_idx)
    pt_loc = (jnp.zeros(m.pt_pos.shape[0], bool)
              .at[m.po_lm].max(m.po_valid & kf_loc[m.po_kf]))
    ln_loc = (jnp.zeros(m.ln_sp.shape[0], bool)
              .at[m.lo_lm].max(m.lo_valid & kf_loc[m.lo_kf]))
    return pt_loc & m.pt_valid, ln_loc & m.ln_valid


@partial(jax.jit, static_argnames=("cfg",))
def initialize_map(cfg: Config, m: MapState, frame: StereoFrame) -> MapState:
    """KF0: every stereo feature becomes a landmark (MapHandler::initialize
    path, mapHandler.cpp:37-94). World frame = KF0 camera frame."""
    return _insert_kf(cfg, m, frame, jnp.eye(4),
                      pt_lm_idx=jnp.full(frame.points.xy.shape[0], -1),
                      ln_lm_idx=jnp.full(frame.lines.sp.shape[0], -1))


@partial(jax.jit, static_argnames=("cfg",))
def add_keyframe(cfg: Config, m: MapState, frame: StereoFrame,
                 t_rel: jax.Array) -> tuple[MapState, KFMatchResult]:
    """KF insertion (addKeyFrame, mapHandler.cpp:113-187): compose pose from
    the previous KF, associate features with local landmarks, create new
    landmarks from unmatched stereo features, update obs + covisibility."""
    prev_idx = m.n_kf - 1
    t_kf_w = m.kf_pose[prev_idx] @ t_rel
    pt_loc, ln_loc = local_landmark_masks(cfg, m, prev_idx)
    match = _match_frame_to_map(cfg, m, frame, t_kf_w, pt_loc, ln_loc)
    m = _insert_kf(cfg, m, frame, t_kf_w, match.pt_lm_idx, match.ln_lm_idx)
    return m, match


def _insert_kf(cfg: Config, m: MapState, frame: StereoFrame,
               t_kf_w: jax.Array, pt_lm_idx: jax.Array,
               ln_lm_idx: jax.Array) -> MapState:
    kf_idx = m.n_kf
    m = m._replace(
        kf_pose=m.kf_pose.at[kf_idx].set(t_kf_w),
        kf_valid=m.kf_valid.at[kf_idx].set(True))

    f = frame.points
    fl = frame.lines
    rot = t_kf_w[:3, :3]
    tr = t_kf_w[:3, 3]
    pt_world = jax.vmap(lambda x: rot @ x + tr)(f.p3d)
    ln_sp_w = jax.vmap(lambda x: rot @ x + tr)(fl.sp3d)
    ln_ep_w = jax.vmap(lambda x: rot @ x + tr)(fl.ep3d)

    # --- create new landmarks from unmatched valid features ---
    new_pt = f.valid & (pt_lm_idx < 0)
    slot_pt = _alloc_slots(~m.pt_valid, new_pt)
    created_pt = slot_pt >= 0
    safe_slot = jnp.where(created_pt, slot_pt, 0)
    m = m._replace(
        pt_pos=m.pt_pos.at[jnp.where(created_pt, slot_pt, m.pt_pos.shape[0])
                           ].set(pt_world, mode="drop"),
        pt_desc=m.pt_desc.at[jnp.where(created_pt, slot_pt, m.pt_pos.shape[0])
                             ].set(f.desc, mode="drop"),
        # reused pool slots must not inherit a culled landmark's obs count
        # (it seeds the descriptor-history ring position)
        pt_obs_n=m.pt_obs_n.at[jnp.where(created_pt, slot_pt,
                                         m.pt_pos.shape[0])
                               ].set(0, mode="drop"))
    new_ln = fl.valid & (ln_lm_idx < 0)
    slot_ln = _alloc_slots(~m.ln_valid, new_ln)
    created_ln = slot_ln >= 0
    drop_l = m.ln_sp.shape[0]
    m = m._replace(
        ln_sp=m.ln_sp.at[jnp.where(created_ln, slot_ln, drop_l)].set(
            ln_sp_w, mode="drop"),
        ln_ep=m.ln_ep.at[jnp.where(created_ln, slot_ln, drop_l)].set(
            ln_ep_w, mode="drop"),
        ln_desc=m.ln_desc.at[jnp.where(created_ln, slot_ln, drop_l)].set(
            fl.desc, mode="drop"),
        ln_obs_n=m.ln_obs_n.at[jnp.where(created_ln, slot_ln, drop_l)].set(
            0, mode="drop"))

    # landmark id per feature after creation
    pt_lm = jnp.where(created_pt, slot_pt, pt_lm_idx)
    ln_lm = jnp.where(created_ln, slot_ln, ln_lm_idx)
    obs_pt = pt_lm >= 0
    obs_ln = ln_lm >= 0
    pt_lm_safe = jnp.where(obs_pt, pt_lm, 0)
    ln_lm_safe = jnp.where(obs_ln, ln_lm, 0)

    # --- covisibility increments (expandGraphs + full_graph++, :303-334) ---
    # for each matched (pre-existing) landmark, +1 with every KF in its obs
    matched_pt_mask = jnp.zeros(m.pt_pos.shape[0], bool).at[
        jnp.where(pt_lm_idx >= 0, pt_lm_idx, m.pt_pos.shape[0])
    ].set(True, mode="drop")
    matched_ln_mask = jnp.zeros(m.ln_sp.shape[0], bool).at[
        jnp.where(ln_lm_idx >= 0, ln_lm_idx, m.ln_sp.shape[0])
    ].set(True, mode="drop")
    inc_p = m.po_valid & matched_pt_mask[m.po_lm]
    inc_l = m.lo_valid & matched_ln_mask[m.lo_lm]
    fg = m.full_graph
    fg = fg.at[kf_idx, m.po_kf].add(inc_p.astype(jnp.int32))
    fg = fg.at[kf_idx, m.lo_kf].add(inc_l.astype(jnp.int32))
    m = m._replace(full_graph=fg)

    # --- append observations ---
    po = _append_obs(m.po_kf, m.po_lm, m.po_uv, m.po_sigma2, m.po_valid,
                     m.po_head, kf_idx, pt_lm_safe, f.xy, f.sigma2, obs_pt)
    lo = _append_obs(m.lo_kf, m.lo_lm, m.lo_le, m.lo_sigma2, m.lo_valid,
                     m.lo_head, kf_idx, ln_lm_safe, fl.le, fl.sigma2, obs_ln)
    m = m._replace(po_kf=po[0], po_lm=po[1], po_uv=po[2], po_sigma2=po[3],
                   po_valid=po[4], po_head=po[5],
                   lo_kf=lo[0], lo_lm=lo[1], lo_le=lo[2], lo_sigma2=lo[3],
                   lo_valid=lo[4], lo_head=lo[5])

    # --- representative descriptor refresh: ring-buffered medoid over the
    # last DESC_HIST observations (see _update_desc_medoid) ---
    pt_hist, pt_desc = _update_desc_medoid(
        m.pt_desc_hist, m.pt_desc, m.pt_obs_n, pt_lm_safe, obs_pt, f.desc)
    ln_hist, ln_desc = _update_desc_medoid(
        m.ln_desc_hist, m.ln_desc, m.ln_obs_n, ln_lm_safe, obs_ln, fl.desc)
    m = m._replace(pt_desc_hist=pt_hist, pt_desc=pt_desc,
                   ln_desc_hist=ln_hist, ln_desc=ln_desc)

    # --- landmark stats + validity ---
    m = m._replace(
        pt_obs_n=m.pt_obs_n.at[pt_lm_safe].add(obs_pt.astype(jnp.int32)),
        pt_last_kf=jnp.maximum(
            m.pt_last_kf,
            jnp.zeros_like(m.pt_last_kf).at[pt_lm_safe].max(
                jnp.where(obs_pt, kf_idx, 0))),
        pt_valid=m.pt_valid.at[
            jnp.where(created_pt, slot_pt, m.pt_pos.shape[0])
        ].set(True, mode="drop"),
        ln_obs_n=m.ln_obs_n.at[ln_lm_safe].add(obs_ln.astype(jnp.int32)),
        ln_last_kf=jnp.maximum(
            m.ln_last_kf,
            jnp.zeros_like(m.ln_last_kf).at[ln_lm_safe].max(
                jnp.where(obs_ln, kf_idx, 0))),
        ln_valid=m.ln_valid.at[
            jnp.where(created_ln, slot_ln, drop_l)
        ].set(True, mode="drop"),
        n_kf=m.n_kf + 1)
    return m


@partial(jax.jit, static_argnames=("cfg",))
def remove_bad_landmarks(cfg: Config, m: MapState) -> MapState:
    """Cull stale under-observed landmarks (removeBadMapLandmarks,
    mapHandler.cpp:2550-2630): non-local landmarks older than 10 KFs with
    fewer than min_lm_obs observations."""
    cur = m.n_kf - 1
    stale_pt = (m.pt_last_kf < cur - 10) & (m.pt_obs_n < cfg.slam.min_lm_obs)
    stale_ln = (m.ln_last_kf < cur - 10) & (m.ln_obs_n < cfg.slam.min_lm_obs)
    pt_valid = m.pt_valid & ~stale_pt
    ln_valid = m.ln_valid & ~stale_ln
    return m._replace(
        pt_valid=pt_valid, ln_valid=ln_valid,
        po_valid=m.po_valid & pt_valid[m.po_lm],
        lo_valid=m.lo_valid & ln_valid[m.lo_lm])


@partial(jax.jit, static_argnames=("cfg",))
def remove_redundant_kfs(cfg: Config, m: MapState) -> tuple[MapState, jax.Array]:
    """Cull keyframes whose landmarks are redundantly observed
    (removeRedundantKFs, mapHandler.cpp:2632-2795 — declared in the
    reference but disabled there as "slow and buggy"; here it is a working
    capability). A KF (not KF0, not one of the last min_kf_local_map) is
    redundant when >= max_common_fts_kf of its observed landmarks carry at
    least 4 observations (i.e. seen by >= 3 other KFs). Its observations are
    invalidated, landmark obs counts decremented, and its covisibility
    row/col cleared; kf_valid marks the hole (pose-graph sequential edges
    chain across holes). At most ONE keyframe — the most redundant — is
    culled per invocation so each decision sees post-cull observation
    counts (mutually-redundant KFs would otherwise all pass the >=3-other-
    observers test simultaneously and strip their shared landmarks); the
    function runs once per KF insertion, so the cull keeps pace with map
    growth. Returns (map, n_removed in {0, 1})."""
    k = m.kf_pose.shape[0]
    ids = jnp.arange(k)
    cur = m.n_kf - 1

    redundant_p = m.po_valid & (m.pt_obs_n[m.po_lm] >= 4)
    redundant_l = m.lo_valid & (m.ln_obs_n[m.lo_lm] >= 4)
    per_kf_total = (jnp.zeros(k).at[m.po_kf].add(m.po_valid * 1.0)
                    .at[m.lo_kf].add(m.lo_valid * 1.0))
    per_kf_red = (jnp.zeros(k).at[m.po_kf].add(redundant_p * 1.0)
                  .at[m.lo_kf].add(redundant_l * 1.0))
    frac = per_kf_red / jnp.maximum(per_kf_total, 1.0)
    eligible = (m.kf_valid & (ids > 0)
                & (ids < cur - cfg.slam.min_kf_local_map)
                & (frac >= cfg.slam.max_common_fts_kf))
    # single most-redundant KF only (see docstring)
    best = jnp.argmax(jnp.where(eligible, frac, -1.0))
    candidate = eligible & (ids == best)

    drop_obs_p = m.po_valid & candidate[m.po_kf]
    drop_obs_l = m.lo_valid & candidate[m.lo_kf]
    pt_obs_n = m.pt_obs_n - (jnp.zeros_like(m.pt_obs_n)
                             .at[m.po_lm].add(drop_obs_p.astype(jnp.int32)))
    ln_obs_n = m.ln_obs_n - (jnp.zeros_like(m.ln_obs_n)
                             .at[m.lo_lm].add(drop_obs_l.astype(jnp.int32)))
    keep_row = ~candidate
    fg = jnp.where(keep_row[:, None] & keep_row[None, :], m.full_graph, 0)
    return m._replace(
        kf_valid=m.kf_valid & keep_row,
        po_valid=m.po_valid & ~drop_obs_p,
        lo_valid=m.lo_valid & ~drop_obs_l,
        pt_obs_n=pt_obs_n, ln_obs_n=ln_obs_n,
        full_graph=fg), jnp.sum(candidate)


N_FUSE = 256  # candidate landmarks compacted per loop side for fusion


def _fuse_pool(desc, pos, valid, last_kf, obs_n, obs_lm, obs_kf, obs_valid,
               kf_prev, kf_curr, near, fuse_r, n_kf_total):
    """Duplicate-landmark merge across a closed loop for one landmark family
    (loopClosureFuseLandmarks, mapHandler.cpp:4425-4714).

    Side A = landmarks last seen around the loop target ``kf_prev``; side B =
    landmarks from the current end of the trajectory. Mutual-best descriptor
    match + post-correction 3D proximity gate; B members merge into their A
    partner (obs redirection + stats concat — the reference's "fuse-two"
    case; its one-sided cases are subsumed because every feature here is
    already a landmark). Returns (remap [P], keep_valid [P], occA, occB
    [n, K] fused-pair KF occupancy for covisibility increments, merged_mask
    [n], n_over_cap) with n = min(N_FUSE, P); ``n_over_cap`` counts
    candidates that did not fit the compaction (no silent caps — callers
    surface it)."""
    p = desc.shape[0]
    n = min(N_FUSE, p)
    ids = jnp.arange(p)
    side_a = valid & (last_kf >= kf_prev - near) & (last_kf <= kf_prev + near)
    side_b = valid & (last_kf >= kf_curr - near) & ~side_a
    n_over_cap = (jnp.maximum(jnp.sum(side_a) - n, 0)
                  + jnp.maximum(jnp.sum(side_b) - n, 0))
    # compact each side to n slots by recency (most recent last_kf first;
    # landmark id breaks ties so the packed key stays unique)
    key_a = jnp.where(side_a, last_kf * p + ids, -1)
    key_b = jnp.where(side_b, last_kf * p + ids, -1)
    a_key = jax.lax.top_k(key_a, n)[0]
    b_key = jax.lax.top_k(key_b, n)[0]
    a_ok = a_key >= 0
    b_ok = b_key >= 0
    a_ids = jnp.where(a_ok, a_key % p, -1)
    b_ids = jnp.where(b_ok, b_key % p, -1)
    a_safe = jnp.where(a_ok, a_ids, 0)
    b_safe = jnp.where(b_ok, b_ids, 0)

    d = hamming_matrix(desc[a_safe], desc[b_safe], a_ok, b_ok
                       ).astype(jnp.float32)
    big = jnp.float32(1 << 16)
    gap = jnp.linalg.norm(pos[a_safe][:, None, :] - pos[b_safe][None, :, :],
                          axis=-1)
    d = jnp.where(gap < fuse_r, d, big)
    mm = match_ops.mutual_best(d)
    merged = mm.valid & (mm.dist < 80) & a_ok & b_ok[mm.idx]

    keep = a_safe                                   # [N_FUSE] A landmark kept
    drop = b_safe[mm.idx]                           # [N_FUSE] B landmark gone
    drop_slot = jnp.where(merged, drop, p)
    keep_slot = jnp.where(merged, keep, p)

    # remap: every obs of the dropped landmark re-targets the kept one
    remap = ids.at[drop_slot].set(keep, mode="drop")
    keep_valid = valid.at[drop_slot].set(False, mode="drop")
    # concat stats onto the kept landmark
    obs_n = obs_n.at[keep_slot].add(
        jnp.where(merged, obs_n[jnp.where(merged, drop, 0)], 0), mode="drop")
    last_kf = jnp.maximum(
        last_kf,
        jnp.zeros_like(last_kf).at[keep_slot].max(
            jnp.where(merged, last_kf[jnp.where(merged, drop, 0)], 0),
            mode="drop"))

    # fused-pair KF occupancy for covisibility increments (:4478-4545): which
    # KFs observe the kept / dropped landmark, via the flat obs table
    inv_keep = jnp.full(p + 1, n, jnp.int32).at[keep_slot].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    inv_drop = jnp.full(p + 1, n, jnp.int32).at[drop_slot].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    row_a = jnp.where(obs_valid, inv_keep[obs_lm], n)
    row_b = jnp.where(obs_valid, inv_drop[obs_lm], n)
    k = n_kf_total
    occ_a = jnp.zeros(n * k, jnp.float32).at[
        jnp.where(row_a < n, row_a * k + obs_kf, n * k)
    ].max(1.0, mode="drop").reshape(n, k)
    occ_b = jnp.zeros(n * k, jnp.float32).at[
        jnp.where(row_b < n, row_b * k + obs_kf, n * k)
    ].max(1.0, mode="drop").reshape(n, k)
    return remap, keep_valid, obs_n, last_kf, occ_a, occ_b, merged, n_over_cap


@partial(jax.jit, static_argnames=("cfg",))
def fuse_loop_landmarks(cfg: Config, m: MapState, kf_prev: jax.Array,
                        kf_curr: jax.Array) -> tuple[MapState, jax.Array]:
    """Merge duplicate landmarks across a just-closed loop
    (loopClosureFuseLandmarks, mapHandler.cpp:4425-4714): after pose-graph
    correction the two loop ends overlap, so landmarks re-observed under new
    ids are fused back, observation tables are redirected, and the
    covisibility graph gains the cross-loop counts that make subsequent
    local maps span the junction. Returns (map, n_fused, n_over_cap) —
    ``n_over_cap`` counts fusion candidates beyond the N_FUSE compaction
    (emitted so the cap is never silent)."""
    near = jnp.asarray(cfg.slam.min_kf_local_map + 3, jnp.int32)
    fuse_r = cfg.slam.max_lm_3d_err
    k = m.full_graph.shape[0]

    (remap_p, pt_valid, pt_obs_n, pt_last_kf,
     occ_ap, occ_bp, merged_p, over_p) = _fuse_pool(
        m.pt_desc, m.pt_pos, m.pt_valid, m.pt_last_kf, m.pt_obs_n,
        m.po_lm, m.po_kf, m.po_valid, kf_prev, kf_curr, near, fuse_r, k)
    (remap_l, ln_valid, ln_obs_n, ln_last_kf,
     occ_al, occ_bl, merged_l, over_l) = _fuse_pool(
        m.ln_desc, 0.5 * (m.ln_sp + m.ln_ep), m.ln_valid, m.ln_last_kf,
        m.ln_obs_n, m.lo_lm, m.lo_kf, m.lo_valid, kf_prev, kf_curr, near,
        fuse_r, k)

    incr = (jnp.einsum("mk,ml->kl", occ_ap, occ_bp)
            + jnp.einsum("mk,ml->kl", occ_al, occ_bl))
    n_fused = jnp.sum(merged_p) + jnp.sum(merged_l)
    m = m._replace(
        pt_valid=pt_valid, pt_obs_n=pt_obs_n, pt_last_kf=pt_last_kf,
        po_lm=remap_p[m.po_lm],
        ln_valid=ln_valid, ln_obs_n=ln_obs_n, ln_last_kf=ln_last_kf,
        lo_lm=remap_l[m.lo_lm],
        full_graph=m.full_graph + incr.astype(jnp.int32))
    return m, n_fused, over_p + over_l


@partial(jax.jit, static_argnames=("cfg", "window", "global_ba"))
def build_local_ba_problem(cfg: Config, m: MapState, window: int = 0,
                           global_ba: bool = False) -> tuple[
        BAProblem, jax.Array, jax.Array, jax.Array]:
    """Assemble the padded local-BA window for the newest KF
    (localBundleAdjustment setup, mapHandler.cpp:1108-1215).

    ``window`` overrides the window capacity; ``global_ba=True`` selects all
    valid KFs and sizes the problem to the full landmark pools and
    observation ring (globalBundleAdjustment, mapHandler.cpp:1844-1948);
    ``SLAMSystem.finish`` routes the solve through the distributed
    landmark-sharded solver when more than one device is available.

    Returns (problem, window_kf_ids [Kw], window_pt_ids [Pw],
    window_ln_ids [Lw], po_src [Op], lo_src [Ol]) for scattering results
    back; ``po_src``/``lo_src`` map each problem observation to its map
    observation-ring slot (-1 = padding) so post-BA outlier marks can be
    applied to the ring (:func:`apply_ba_outliers`).
    """
    cap = cfg.cap
    kw = window or (cap.n_kf_max if global_ba else cap.n_kf_window)
    cur = m.n_kf - 1
    if global_ba:
        kf_loc = m.kf_valid
    else:
        kf_loc = local_kf_mask(cfg, m, cur)
    # newest kw local KFs -> window slots (order: oldest..newest)
    k = m.kf_pose.shape[0]
    ids = jnp.arange(k)
    key = jnp.where(kf_loc, ids, -1)
    top = jnp.sort(jax.lax.top_k(key, kw)[0])           # [-1.. or ids]
    win_ids = top                                        # [kw]
    win_ok = win_ids >= 0
    win_ids_safe = jnp.where(win_ok, win_ids, 0)
    # global kf -> window slot map
    kf2slot = jnp.full(k, -1, jnp.int32).at[win_ids_safe].set(
        jnp.where(win_ok, jnp.arange(kw, dtype=jnp.int32), -1), mode="drop")

    if global_ba:
        pt_loc, ln_loc = m.pt_valid, m.ln_valid
        pw, lw = m.pt_pos.shape[0], m.ln_sp.shape[0]
    else:
        pt_loc, ln_loc = local_landmark_masks(cfg, m, cur)
        pw = min(cap.n_obs_pt // 2, m.pt_pos.shape[0])
        lw = min(cap.n_obs_ln // 2, m.ln_sp.shape[0])
    p_ids = jax.lax.top_k(jnp.where(pt_loc, jnp.arange(m.pt_pos.shape[0]),
                                    -1), pw)[0]
    l_ids = jax.lax.top_k(jnp.where(ln_loc, jnp.arange(m.ln_sp.shape[0]),
                                    -1), lw)[0]
    p_ok = p_ids >= 0
    l_ok = l_ids >= 0
    p_safe = jnp.where(p_ok, p_ids, 0)
    l_safe = jnp.where(l_ok, l_ids, 0)
    pt2slot = jnp.full(m.pt_pos.shape[0], -1, jnp.int32).at[p_safe].set(
        jnp.where(p_ok, jnp.arange(pw, dtype=jnp.int32), -1), mode="drop")
    ln2slot = jnp.full(m.ln_sp.shape[0], -1, jnp.int32).at[l_safe].set(
        jnp.where(l_ok, jnp.arange(lw, dtype=jnp.int32), -1), mode="drop")

    # gauge: the oldest window KF is frozen (:1119)
    first_slot = jnp.argmax(win_ok)  # first valid slot
    kf_free = win_ok & (jnp.arange(kw) != first_slot)

    if not global_ba and cap.n_kf_frozen > 0:
        # out-of-window KFs that observe window landmarks enter as FROZEN
        # constants (the reference keeps non-local KFs' observations with
        # kf_idx_loc == -1, i.e. constant poses, mapHandler.cpp:1299-1304)
        # so the window solve cannot drag shared landmarks off their
        # older-KF evidence. Most recent such KFs fill the frozen slots.
        kwf = cap.n_kf_frozen
        po_out = m.po_valid & (kf2slot[m.po_kf] < 0) & (pt2slot[m.po_lm] >= 0)
        lo_out = m.lo_valid & (kf2slot[m.lo_kf] < 0) & (ln2slot[m.lo_lm] >= 0)
        kf_has_out = (jnp.zeros(k, bool)
                      .at[m.po_kf].max(po_out, mode="drop")
                      .at[m.lo_kf].max(lo_out, mode="drop"))
        fr_key = jnp.where(kf_has_out & m.kf_valid, ids, -1)
        fr_ids = jax.lax.top_k(fr_key, kwf)[0]
        fr_ok = fr_ids >= 0
        kf2slot = kf2slot.at[jnp.where(fr_ok, fr_ids, k)].set(
            jnp.where(fr_ok, kw + jnp.arange(kwf, dtype=jnp.int32), -1),
            mode="drop")
        win_ids = jnp.concatenate([win_ids, fr_ids])
        win_ok = jnp.concatenate([win_ok, fr_ok])
        win_ids_safe = jnp.where(win_ok, win_ids, 0)
        kf_free = jnp.concatenate([kf_free, jnp.zeros(kwf, bool)])

    # observation selection: kf in window (free or frozen) AND lm in window
    po_sel = m.po_valid & (kf2slot[m.po_kf] >= 0) & (pt2slot[m.po_lm] >= 0)
    lo_sel = m.lo_valid & (kf2slot[m.lo_kf] >= 0) & (ln2slot[m.lo_lm] >= 0)
    if global_ba:  # the whole observation ring participates
        op, ol = m.po_kf.shape[0], m.lo_kf.shape[0]
    else:
        op, ol = cap.n_obs_pt, cap.n_obs_ln
    # rank free-window observations above frozen-KF observations so anchors
    # never crowd the window's own evidence out of the padded slots
    n_po, n_lo = m.po_kf.shape[0], m.lo_kf.shape[0]
    po_pri = (kf2slot[m.po_kf] < kw).astype(jnp.int32)
    lo_pri = (kf2slot[m.lo_kf] < kw).astype(jnp.int32)
    po_rank = jax.lax.top_k(
        jnp.where(po_sel, po_pri * n_po + jnp.arange(n_po), -1), op)[0]
    lo_rank = jax.lax.top_k(
        jnp.where(lo_sel, lo_pri * n_lo + jnp.arange(n_lo), -1), ol)[0]
    po_ok = po_rank >= 0
    lo_ok = lo_rank >= 0
    po_i = jnp.where(po_ok, po_rank % n_po, 0)
    lo_i = jnp.where(lo_ok, lo_rank % n_lo, 0)

    prob = BAProblem(
        kf_pose=m.kf_pose[win_ids_safe],
        kf_free=kf_free, kf_valid=win_ok,
        pt_pos=m.pt_pos[p_safe], pt_valid=p_ok,
        ln_sp=m.ln_sp[l_safe], ln_ep=m.ln_ep[l_safe], ln_valid=l_ok,
        po_kf=kf2slot[m.po_kf[po_i]], po_lm=pt2slot[m.po_lm[po_i]],
        po_uv=m.po_uv[po_i], po_sigma2=m.po_sigma2[po_i],
        po_valid=po_ok,
        lo_kf=kf2slot[m.lo_kf[lo_i]], lo_lm=ln2slot[m.lo_lm[lo_i]],
        lo_le=m.lo_le[lo_i], lo_sigma2=m.lo_sigma2[lo_i],
        lo_valid=lo_ok,
    )
    po_src = jnp.where(po_ok, po_i, -1).astype(jnp.int32)
    lo_src = jnp.where(lo_ok, lo_i, -1).astype(jnp.int32)
    return prob, win_ids, p_ids, l_ids, po_src, lo_src


@partial(jax.jit, static_argnames=("cfg",))
def apply_ba_result(cfg: Config, m: MapState, res, win_ids, p_ids, l_ids
                    ) -> MapState:
    """Write optimized poses/landmarks back (:1689-1712)."""
    k = m.kf_pose.shape[0]
    win_ok = win_ids >= 0
    kf_dst = jnp.where(win_ok, win_ids, k)
    kf_pose = m.kf_pose.at[kf_dst].set(res.kf_pose, mode="drop")
    p_dst = jnp.where(p_ids >= 0, p_ids, m.pt_pos.shape[0])
    pt_pos = m.pt_pos.at[p_dst].set(res.pt_pos, mode="drop")
    l_dst = jnp.where(l_ids >= 0, l_ids, m.ln_sp.shape[0])
    ln_sp = m.ln_sp.at[l_dst].set(res.ln_sp, mode="drop")
    ln_ep = m.ln_ep.at[l_dst].set(res.ln_ep, mode="drop")
    return m._replace(kf_pose=kf_pose, pt_pos=pt_pos, ln_sp=ln_sp,
                      ln_ep=ln_ep)


@partial(jax.jit, static_argnames=("cfg",))
def apply_ba_outliers(cfg: Config, m: MapState, res, po_src: jax.Array,
                      lo_src: jax.Array) -> MapState:
    """Delete the observations BA marked as outliers
    (mapHandler.cpp:1714-1836): invalidate their obs-ring entries, decrement
    the affected landmarks' observation counts, and decrement the
    covisibility pair counts those observations contributed. Outlier
    associations otherwise persist in the ring forever and keep feeding
    every later window solve.

    ``po_src``/``lo_src`` are the ring slots of the problem's observations
    (from :func:`build_local_ba_problem`); ``res.po_inlier``/``lo_inlier``
    are the solver's post-convergence chi2 marks."""
    def one_family(src, inlier, obs_valid, obs_lm, obs_kf, lm_obs_n, n_lm):
        cap = obs_valid.shape[0]
        out = (src >= 0) & ~inlier                     # [Op_problem]
        dst = jnp.where(out, src, cap)
        new_valid = obs_valid.at[dst].set(False, mode="drop")
        # landmark obs-count decrement
        lm_of = obs_lm[jnp.where(out, src, 0)]
        dec_dst = jnp.where(out, lm_of, n_lm)
        obs_n = lm_obs_n.at[dec_dst].add(-1, mode="drop")
        # covisibility: per-landmark KF occupancy before/after deletion;
        # the symmetrized pair-count loss is P_prev P_prev^T - P_new P_new^T
        k = m.full_graph.shape[0]
        occ_prev = jnp.zeros(n_lm * k).at[
            jnp.where(obs_valid, obs_lm * k + obs_kf, n_lm * k)
        ].max(1.0, mode="drop").reshape(n_lm, k)
        occ_new = jnp.zeros(n_lm * k).at[
            jnp.where(new_valid, obs_lm * k + obs_kf, n_lm * k)
        ].max(1.0, mode="drop").reshape(n_lm, k)
        dec_sym = occ_prev.T @ occ_prev - occ_new.T @ occ_new
        return new_valid, obs_n, dec_sym

    po_valid, pt_obs_n, dec_p = one_family(
        po_src, res.po_inlier, m.po_valid, m.po_lm, m.po_kf, m.pt_obs_n,
        m.pt_pos.shape[0])
    lo_valid, ln_obs_n, dec_l = one_family(
        lo_src, res.lo_inlier, m.lo_valid, m.lo_lm, m.lo_kf, m.ln_obs_n,
        m.ln_sp.shape[0])
    # full_graph stores each pair count in ONE orientation (insertion writes
    # the [newer, older] row; usage symmetrizes, local_kf_mask): subtract the
    # strictly-lower triangle of the symmetric loss so the symmetrized total
    # stays exact regardless of which orientation held the original count.
    dec = jnp.tril(dec_p + dec_l, k=-1).astype(jnp.int32)
    return m._replace(po_valid=po_valid, lo_valid=lo_valid,
                      pt_obs_n=pt_obs_n, ln_obs_n=ln_obs_n,
                      full_graph=m.full_graph - dec)
