"""Fused per-keyframe mapping pipeline: one jitted device program.

The reference runs its whole mapping stack synchronously inside
``MapHandler::addKeyFrame`` (mapHandler.cpp:113-187): data association,
local BA, landmark culling, BoW insertion, and (when enabled) loop-candidate
scoring + verification. Here the same pipeline is fused into a single XLA
program so a keyframe costs ONE dispatch instead of eight, each with its
own host-device latency; fusing also lets XLA overlap independent stages
(BoW scoring does not depend on BA).

``verify_loop`` runs speculatively on the clamped candidate (cand < 0 means
"no candidate"; the host ignores the verification in that case) — the same
speculative-dispatch trick the async driver uses (slam.py async_mapping).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gfplslam_tpu.config import Config
from gfplslam_tpu.models import ba as ba_ops
from gfplslam_tpu.models import loop as loop_ops
from gfplslam_tpu.models import map as map_ops


class MappingResult(NamedTuple):
    map: map_ops.MapState
    loop_state: loop_ops.LoopState
    cand: jax.Array          # int32 loop-candidate KF index or -1
    verification: loop_ops.LoopVerification  # for cand (speculative)
    n_pt_matched: jax.Array
    n_ln_matched: jax.Array
    ba_err: jax.Array
    ba_iters: jax.Array


@partial(jax.jit, static_argnames=("cfg", "run_ba", "run_lc",
                                   "cull_redundant"))
def mapping_step(cfg: Config, m: map_ops.MapState, ls: loop_ops.LoopState,
                 frame, t_rel: jax.Array, run_ba: bool = True,
                 run_lc: bool = True,
                 cull_redundant: bool = False) -> MappingResult:
    """KF insertion + local BA + culling + BoW + LC scoring, fused.

    Order mirrors ``MapHandler::addKeyFrame`` (mapHandler.cpp:113-187):
    lookForCommonMatches -> localBundleAdjustment -> removeBadMapLandmarks
    -> insertKFBowVectorPL -> lookForLoopCandidates.
    """
    m, match = map_ops.add_keyframe(cfg, m, frame, t_rel)
    ba_err = jnp.asarray(0.0)
    ba_iters = jnp.asarray(0, jnp.int32)
    if run_ba:
        prob, w_ids, p_ids, l_ids, po_src, lo_src = \
            map_ops.build_local_ba_problem(cfg, m)
        res = ba_ops.solve_ba(cfg.camera, prob,
                              lambda0=cfg.slam.lambda_lba_lm,
                              lambda_k=cfg.slam.lambda_lba_k,
                              max_iters=cfg.slam.max_iters_lba)
        m = map_ops.apply_ba_result(cfg, m, res, w_ids, p_ids, l_ids)
        # delete the observations BA marked as outliers (the reference's
        # post-BA obs deletion, mapHandler.cpp:1714-1836)
        m = map_ops.apply_ba_outliers(cfg, m, res, po_src, lo_src)
        ba_err = res.err
        ba_iters = res.iters
    m = map_ops.remove_bad_landmarks(cfg, m)
    if cull_redundant:
        m, _ = map_ops.remove_redundant_kfs(cfg, m)
    kf_idx = m.n_kf - 1
    ls = loop_ops.insert_kf_bow(cfg, ls, kf_idx, frame)
    if run_lc:
        cand = loop_ops.look_for_loop_candidates(cfg, ls, m.full_graph,
                                                 kf_idx)
        ver = loop_ops.verify_loop(cfg, ls, jnp.maximum(cand, 0), kf_idx)
    else:
        cand = jnp.asarray(-1, jnp.int32)
        ver = loop_ops.LoopVerification(
            accepted=jnp.asarray(False), t_rel=jnp.eye(4),
            n_inliers=jnp.asarray(0, jnp.int32), err=jnp.asarray(0.0))
    return MappingResult(map=m, loop_state=ls, cand=cand, verification=ver,
                         n_pt_matched=match.n_pt_matched,
                         n_ln_matched=match.n_ln_matched,
                         ba_err=ba_err, ba_iters=ba_iters)


@partial(jax.jit, static_argnames=("cfg", "run_ba", "run_lc",
                                   "cull_redundant"))
def mapping_step_chunk(cfg: Config, m: map_ops.MapState,
                       ls: loop_ops.LoopState, frames, j: jax.Array,
                       poses: jax.Array, t_prev_kf: jax.Array,
                       run_ba: bool = True, run_lc: bool = True,
                       cull_redundant: bool = False):
    """:func:`mapping_step` fed directly from a chunk scan's device-stacked
    outputs: slices frame ``j`` and computes the KF-relative motion
    ``inv(t_prev_kf) @ poses[j]`` ON DEVICE, so driving a keyframe costs
    one dispatch and zero host->device uploads (no per-KF 4x4 upload and
    no separate _take_frame dispatch, each a host round trip).

    Returns (MappingResult, t_abs) where ``t_abs`` is this KF's absolute
    scan pose — the next call's ``t_prev_kf`` (a device-resident carry).
    """
    from gfplslam_tpu.utils import se3

    frame = jax.tree.map(lambda x: x[j], frames)
    t_abs = poses[j]
    t_rel = se3.inverse_se3(t_prev_kf) @ t_abs
    res = mapping_step(cfg, m, ls, frame, t_rel, run_ba=run_ba,
                       run_lc=run_lc, cull_redundant=cull_redundant)
    return res, t_abs
