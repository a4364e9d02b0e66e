"""Loop closure: BoW scoring, candidate gating, verification, PGO."""

import jax.numpy as jnp
import numpy as np
import pytest

from gfplslam_tpu.config import CameraParams, CapacityParams, Config, OrbParams, SlamParams
from gfplslam_tpu.io import synthetic
from gfplslam_tpu.models import frame as frame_mod
from gfplslam_tpu.models import loop as loop_ops
from gfplslam_tpu.utils import se3


@pytest.fixture(scope="module")
def cfg():
    return Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_kf_max=32, vocab_k=128),
        orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11),
        slam=SlamParams(lc_kf_dist=4, lc_kf_max_dist=3, lc_nkf_closest=1),
    )


def make_frames(cfg, n, seed=8, revisit=None):
    world = synthetic.make_world(n_frames=n, n_points=250, n_lines=40,
                                 seed=seed)
    if revisit is not None:
        # last pose revisits an earlier pose
        world.poses[-1] = world.poses[revisit].copy()
    fs = []
    for i in range(n):
        il, ir = synthetic.render_frame(world, i, noise=1.0)
        fs.append(frame_mod.process_stereo_pair(
            jnp.asarray(il), jnp.asarray(ir), cfg, jnp.asarray(20.0)))
    return world, fs


def test_bow_self_similarity(cfg):
    world, fs = make_frames(cfg, 3)
    ls = loop_ops.empty_loop_state(cfg)
    for i, f in enumerate(fs):
        ls = loop_ops.insert_kf_bow(cfg, ls, jnp.asarray(i), f)
    v = loop_ops._idf_normalize(ls.bow_p[:2], ls.df_p, ls.n_docs)
    # same frame scores 1.0 with itself; different frames score less
    assert abs(float(loop_ops.l1_score(v[0], v[0])) - 1.0) < 1e-5
    s01 = float(loop_ops.l1_score(v[0], v[1]))
    assert 0.0 < s01 < 1.0


def test_bow_revisit_scores_high(cfg):
    """Frames of scene A must score higher with other A frames than with
    B frames (different landmark textures). A same-trajectory revisit is
    not discriminative — every frame of a gently-moving camera sees nearly
    the same landmarks, and uniformly high scores are then correct."""
    world_a, fs_a = make_frames(cfg, 4, seed=8)
    world_b, fs_b = make_frames(cfg, 3, seed=99)
    ls = loop_ops.empty_loop_state(cfg)
    seq = fs_a[:3] + fs_b + [fs_a[3]]
    for i, f in enumerate(seq):
        ls = loop_ops.insert_kf_bow(cfg, ls, jnp.asarray(i), f)
    conf = np.asarray(ls.conf)
    # the best match of the scene-A query must be a scene-A frame, and
    # same-scene frames must dominate on average
    assert int(np.argmax(conf[6, :6])) < 3, conf[6, :8]
    assert conf[6, :3].mean() > conf[6, 3:6].mean(), conf[6, :8]


def test_verify_loop_recovers_relative_pose(cfg):
    world, fs = make_frames(cfg, 8, revisit=1)
    ls = loop_ops.empty_loop_state(cfg)
    for i, f in enumerate(fs):
        ls = loop_ops.insert_kf_bow(cfg, ls, jnp.asarray(i), f)
    ver = loop_ops.verify_loop(cfg, ls, jnp.asarray(1), jnp.asarray(7))
    assert bool(ver.accepted), (float(ver.err), int(ver.n_inliers))
    # frames 1 and 7 share the same pose -> relative pose ~ identity
    tw = np.asarray(se3.logmap_se3(ver.t_rel))
    assert np.linalg.norm(tw) < 0.05, tw


def test_verify_loop_rejects_unrelated(cfg):
    # two worlds with different content: verification must fail
    world_a, fs_a = make_frames(cfg, 2, seed=8)
    world_b, fs_b = make_frames(cfg, 2, seed=99)
    ls = loop_ops.empty_loop_state(cfg)
    ls = loop_ops.insert_kf_bow(cfg, ls, jnp.asarray(0), fs_a[0])
    ls = loop_ops.insert_kf_bow(cfg, ls, jnp.asarray(1), fs_b[0])
    ver = loop_ops.verify_loop(cfg, ls, jnp.asarray(0), jnp.asarray(1))
    assert not bool(ver.accepted)


def test_pose_graph_closes_drift():
    """A drifted circular pose chain + one exact loop edge: PGO must pull
    the endpoints together."""
    k = 8
    poses = [np.eye(4, dtype=np.float32)]
    # true motion: 0.2m steps in +x; estimated chain drifts in y
    for i in range(1, k):
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = 0.2
        t[1, 3] = 0.02  # drift
        poses.append(poses[-1] @ t)
    poses = jnp.asarray(np.stack(poses))
    valid = jnp.ones(k, bool)
    # loop edge: KF7 is truly at x=1.4, y=0 relative to KF0
    t_meas = np.eye(4, dtype=np.float32)
    t_meas[0, 3] = 1.4
    edges = loop_ops.build_edges(poses, valid,
                                 jnp.zeros((k, k), jnp.int32), 100,
                                 jnp.asarray(0), jnp.asarray(k - 1),
                                 jnp.asarray(t_meas), max_edges=16)
    fixed = jnp.zeros(k, bool).at[0].set(True)
    new_poses = loop_ops.optimize_pose_graph(poses, valid, edges, fixed,
                                             iters=30)
    end = np.asarray(new_poses[-1])
    assert abs(end[0, 3] - 1.4) < 0.03, end[:3, 3]
    assert abs(end[1, 3]) < 0.05, end[:3, 3]
    # gauge KF unchanged
    np.testing.assert_allclose(np.asarray(new_poses[0]), np.eye(4), atol=1e-5)


def test_rigid_correct_landmarks():
    kf_old = jnp.asarray(np.stack([np.eye(4, dtype=np.float32)] * 2))
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [1.0, 0, 0]
    kf_new = jnp.asarray(np.stack([np.eye(4, dtype=np.float32), shift]))
    lm = jnp.asarray([[0.0, 0, 5], [0.0, 0, 5]])
    lm_kf = jnp.asarray([0, 1], jnp.int32)
    out = loop_ops.rigid_correct_landmarks(kf_old, kf_new, lm, lm_kf,
                                           jnp.ones(2, bool))
    np.testing.assert_allclose(np.asarray(out[0]), [0, 0, 5], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out[1]), [1, 0, 5], atol=1e-6)


def test_topk_snapshot_keeps_best_scores():
    """When a frame holds more valid features than the snapshot capacity,
    the kept set must be the TOP-scoring ones (loop verification runs on
    these snapshots; dropping an arbitrary pyramid-level-ordered slice
    weakened it at full budgets)."""
    n, n_out = 64, 16
    rng = np.random.default_rng(5)
    score = jnp.asarray(rng.uniform(0, 100, n).astype(np.float32))
    valid = jnp.asarray(rng.uniform(0, 1, n) < 0.8)
    payload = jnp.arange(n, dtype=jnp.float32)[:, None]
    ok, out = loop_ops._topk_snapshot(valid, score, n_out, payload)
    kept = set(np.asarray(out[np.asarray(ok)])[:, 0].astype(int))
    want = sorted(np.nonzero(np.asarray(valid))[0],
                  key=lambda i: -float(score[i]))[:n_out]
    assert kept == set(int(i) for i in want)
    # padding branch: capacity below snapshot size zero-pads validly
    ok2, out2 = loop_ops._topk_snapshot(valid[:8], score[:8], n_out,
                                        payload[:8])
    assert ok2.shape == (n_out,)
    assert int(np.asarray(ok2).sum()) == int(np.asarray(valid[:8]).sum())


def _synthetic_pair_state(cfg, rng, true_t, inlier_frac, n_feat=200):
    """LoopState with two KF snapshots where only ``inlier_frac`` of the
    mutual-best matches are geometrically consistent with ``true_t``
    (T_curr<-prev) — the high-outlier regime computeRelativePoseRobustGN
    exists for (mapHandler.cpp:3547-3948)."""
    import jax
    from gfplslam_tpu.ops import camera as cam_ops
    cam = cfg.camera
    ls = loop_ops.empty_loop_state(cfg)
    n_slot = ls.pt_p3d.shape[1]
    n_feat = min(n_feat, n_slot)
    p3d = np.stack([rng.uniform(-2, 2, n_feat), rng.uniform(-1.5, 1.5, n_feat),
                    rng.uniform(3, 12, n_feat)], 1).astype(np.float32)
    desc = rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint32)
    uv_prev = np.asarray(cam_ops.project_batch(cam, jnp.asarray(p3d)))
    pc_curr = (true_t[:3, :3] @ p3d.T).T + true_t[:3, 3]
    uv_curr = np.array(cam_ops.project_batch(cam, jnp.asarray(
        pc_curr.astype(np.float32))))
    # outliers: curr-side observation replaced by a random image point
    # (descriptor still matches, so the MATCH is formed and must be stripped
    # by the solver's MAD stage, not the matcher)
    n_out = int(n_feat * (1.0 - inlier_frac))
    out_idx = rng.choice(n_feat, n_out, replace=False)
    uv_curr[out_idx] = np.stack([rng.uniform(10, cam.width - 10, n_out),
                                 rng.uniform(10, cam.height - 10, n_out)], 1)

    def fill(ls, k, p3, uv):
        pad = n_slot - n_feat
        z = lambda a: jnp.asarray(np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)))
        return ls._replace(
            pt_p3d=ls.pt_p3d.at[k].set(z(p3)),
            pt_uv=ls.pt_uv.at[k].set(z(uv.astype(np.float32))),
            pt_desc=ls.pt_desc.at[k].set(z(desc)),
            pt_sigma2=ls.pt_sigma2.at[k].set(jnp.ones(n_slot)),
            pt_valid=ls.pt_valid.at[k].set(
                jnp.arange(n_slot) < n_feat))
    ls = fill(ls, 0, p3d, uv_prev)
    ls = fill(ls, 1, p3d, uv_curr)
    return ls


def test_verify_loop_high_outlier_accepts_true_pose(cfg):
    """60% wrong-geometry matches: the two-stage MAD solver must still
    recover the true relative pose and accept (the case the reference's
    iteratively-reweighted RobustGN variant exists for)."""
    rng = np.random.default_rng(3)
    true_t = np.eye(4, dtype=np.float32)
    true_t[:3, 3] = [0.25, -0.1, 0.3]
    c, s = np.cos(0.06), np.sin(0.06)
    true_t[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                              np.float32)
    ls = _synthetic_pair_state(cfg, rng, true_t, inlier_frac=0.4)
    ver = loop_ops.verify_loop(cfg, ls, jnp.asarray(0), jnp.asarray(1))
    assert bool(ver.accepted), (float(ver.err), int(ver.n_inliers))
    est = np.asarray(ver.t_rel)
    assert np.linalg.norm(est[:3, 3] - true_t[:3, 3]) < 0.05, est
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(est[:3, :3].T @ true_t[:3, :3]) - 1) / 2, -1, 1)))
    assert ang < 1.5, ang


def test_verify_loop_overwhelming_outliers_rejected(cfg):
    """95% wrong matches: verification must REJECT (the gates are the
    containment for perceptual-aliasing candidates)."""
    rng = np.random.default_rng(4)
    true_t = np.eye(4, dtype=np.float32)
    true_t[:3, 3] = [0.25, -0.1, 0.3]
    ls = _synthetic_pair_state(cfg, rng, true_t, inlier_frac=0.05)
    ver = loop_ops.verify_loop(cfg, ls, jnp.asarray(0), jnp.asarray(1))
    assert not bool(ver.accepted)
