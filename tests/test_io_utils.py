"""IO + utility subsystems: checkpointing, trajectories, native loader,
dataset parsing, viz, vocab training."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from gfplslam_tpu.utils import checkpoint, trajectory


def test_checkpoint_roundtrip(tmp_path):
    from gfplslam_tpu.config import CapacityParams, Config
    from gfplslam_tpu.models import map as map_ops
    from gfplslam_tpu.models import loop as loop_ops
    cfg = Config(cap=CapacityParams(n_kf_max=8, n_map_pt=64, n_map_ln=32,
                                    n_obs_pt=32, n_obs_ln=16, vocab_k=32))
    m = map_ops.empty_map(cfg)
    m = m._replace(n_kf=jnp.asarray(3, jnp.int32),
                   pt_pos=m.pt_pos.at[0].set(jnp.asarray([1.0, 2.0, 3.0])))
    ls = loop_ops.empty_loop_state(cfg)
    p = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(p, map=m, loop=ls)
    out = checkpoint.load_state(p, map=map_ops.empty_map(cfg),
                                loop=loop_ops.empty_loop_state(cfg))
    assert int(out["map"].n_kf) == 3
    np.testing.assert_allclose(np.asarray(out["map"].pt_pos[0]), [1, 2, 3])
    assert out["loop"].bow_p.shape == ls.bow_p.shape


def test_tum_roundtrip(tmp_path, rng):
    from gfplslam_tpu.utils.se3 import expmap_se3
    poses = [np.asarray(expmap_se3(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * 0.3))) for _ in range(5)]
    ts = np.arange(5) * 0.1
    p = str(tmp_path / "traj.txt")
    trajectory.write_tum(p, ts, poses)
    ts2, poses2 = trajectory.read_tum(p)
    np.testing.assert_allclose(ts2, ts, atol=1e-6)
    for a, b in zip(poses, poses2):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_ate_alignment_invariance(rng):
    from gfplslam_tpu.utils.se3 import expmap_se3
    gt = np.stack([np.asarray(expmap_se3(jnp.asarray(
        rng.normal(size=6).astype(np.float32)))) for _ in range(10)])
    # estimate = rigidly transformed ground truth -> ATE must be ~0
    t = np.asarray(expmap_se3(jnp.asarray(
        np.array([1.0, 2, 3, 0.3, 0.2, 0.1], np.float32))))
    est = np.einsum("ij,njk->nik", t, gt)
    assert trajectory.ate_rmse(est, gt) < 1e-5


def test_native_loader_decode(tmp_path):
    from gfplslam_tpu.io import native_loader
    if not native_loader.native_available():
        pytest.skip("native loader not built")
    cv2 = pytest.importorskip("cv2")
    img = (np.arange(48 * 64).reshape(48, 64) % 251).astype(np.uint8)
    p = str(tmp_path / "img.png")
    cv2.imwrite(p, img)
    out = native_loader.decode_image(p)
    np.testing.assert_allclose(out, img.astype(np.float32), atol=0.5)


def test_native_stereo_loader(tmp_path):
    from gfplslam_tpu.io import native_loader
    if not native_loader.native_available():
        pytest.skip("native loader not built")
    cv2 = pytest.importorskip("cv2")
    paths_l, paths_r = [], []
    for i in range(5):
        il = np.full((32, 40), i * 10, np.uint8)
        ir = np.full((32, 40), i * 10 + 5, np.uint8)
        pl = str(tmp_path / f"l{i}.png")
        pr = str(tmp_path / f"r{i}.png")
        cv2.imwrite(pl, il)
        cv2.imwrite(pr, ir)
        paths_l.append(pl)
        paths_r.append(pr)
    loader = native_loader.StereoLoader(paths_l, paths_r, 40, 32,
                                        n_threads=2, queue_depth=2)
    got = list(loader)
    assert [g[0] for g in got] == [0, 1, 2, 3, 4]
    for i, il, ir in got:
        assert abs(float(il[0, 0]) - i * 10) < 0.5
        assert abs(float(ir[0, 0]) - (i * 10 + 5)) < 0.5
    loader.close()


def test_viz_writes_pngs(tmp_path, rng):
    from gfplslam_tpu.utils import viz
    poses = np.tile(np.eye(4), (6, 1, 1))
    poses[:, 0, 3] = np.arange(6) * 0.1
    viz.plot_trajectory(str(tmp_path / "t.png"), poses, poses)
    viz.plot_map(str(tmp_path / "m.png"),
                 rng.normal(size=(20, 3)), np.ones(20, bool),
                 rng.normal(size=(5, 3)), rng.normal(size=(5, 3)),
                 np.ones(5, bool), poses)
    assert (tmp_path / "t.png").stat().st_size > 1000
    assert (tmp_path / "m.png").stat().st_size > 1000


def test_vocab_kmajority(rng):
    from gfplslam_tpu.apps.train_vocab import kmajority, pack_bits, unpack_bits
    desc = rng.integers(0, 2 ** 32, size=(100, 8), dtype=np.uint32)
    np.testing.assert_array_equal(pack_bits(unpack_bits(desc)), desc)
    vocab = kmajority(desc, k=8, iters=3)
    assert vocab.shape == (8, 8) and vocab.dtype == np.uint32


def test_timestamp_pairing():
    from gfplslam_tpu.io.datasets import _pair_by_timestamp
    ts_l = np.array([0.0, 0.05, 0.10, 0.151])
    ts_r = np.array([0.001, 0.049, 0.2])
    pairs = _pair_by_timestamp(ts_l, ts_r)
    assert (0, 0) in pairs and (1, 1) in pairs
    assert all(j != 2 or i == 3 for i, j in pairs) is not None
    assert (2, 2) not in pairs  # 0.10 vs 0.2 beyond 3 ms


def test_gazebo_loader(tmp_path):
    """Gazebo layout (batch_script/Run_Gazebo.py + gazebo_params.yaml):
    cam0/data + cam1/data, ideal-pinhole 640x480 rig, baseline 0.1 m."""
    from gfplslam_tpu.io.datasets import load_gazebo
    for cam in ("cam0", "cam1"):
        d = tmp_path / cam / "data"
        d.mkdir(parents=True)
        for i in range(3):
            (d / f"{int(1e9 * 0.05 * i):019d}.png").write_bytes(b"x")
    seq = load_gazebo(str(tmp_path))
    assert len(seq.paths_l) == 3 and len(seq.paths_r) == 3
    assert seq.cam.width == 640 and seq.cam.height == 480
    assert abs(seq.cam.fx - 554.25626) < 1e-5
    assert abs(seq.cam.baseline - 0.1) < 1e-9
    assert abs(seq.timestamps[1] - 0.05) < 1e-6


def test_euroc_asl_tree_end_to_end(tmp_path):
    """Full real-dataset ingestion path on a synthetic ASL tree: epoch-ns
    PNG filenames -> load_euroc (pairing + Bouguet rectification + GT csv)
    -> native prefetching decoder -> streaming chunk driver with
    EPOCH-SCALE timestamps (the path that once silently lost track
    when absolute times were cast to float32)."""
    import cv2
    import jax.numpy as jnp
    from gfplslam_tpu.config import (CameraParams, CapacityParams, Config,
                                     OrbParams)
    from gfplslam_tpu.io import datasets, native_loader, synthetic
    from gfplslam_tpu.models.slam import SLAMSystem
    from gfplslam_tpu.ops.camera import stereo_rectify
    from gfplslam_tpu.utils.trajectory import ate_rmse

    # small pinhole rig, zero distortion, pure-baseline extrinsics
    calib = dict(
        kl=np.array([[217.6, 0, 183.7], [0, 217.6, 126.1], [0, 0, 1.0]]),
        kr=np.array([[217.6, 0, 183.7], [0, 217.6, 126.1], [0, 0, 1.0]]),
        dl=np.zeros(5), dr=np.zeros(5),
        r=np.eye(3), t=np.array([0.11, 0.0, 0.0]),
        width=376, height=240, equidistant=False)
    maps = stereo_rectify(calib["kl"], calib["dl"], calib["kr"], calib["dr"],
                          calib["r"], calib["t"], 376, 240)
    cam = maps.cam

    n = 12
    world = synthetic.make_world(n_frames=n, n_points=300, n_lines=40,
                                 seed=11, cam=cam)
    base_ns = 1403715273262140000  # MH_01-style epoch nanoseconds
    cam0 = tmp_path / "mav0" / "cam0" / "data"
    cam1 = tmp_path / "mav0" / "cam1" / "data"
    cam0.mkdir(parents=True)
    cam1.mkdir(parents=True)
    gt_dir = tmp_path / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True)
    gt_rows = ["#ts,x,y,z,qw,qx,qy,qz"]
    for i in range(n):
        il, ir = synthetic.render_frame(world, i, noise=1.0)
        ns = base_ns + int(world.timestamps[i] * 1e9)
        u8 = lambda x: np.clip(np.round(x), 0, 255).astype(np.uint8)
        cv2.imwrite(str(cam0 / f"{ns}.png"), u8(il))
        cv2.imwrite(str(cam1 / f"{ns}.png"), u8(ir))
        p = world.poses[i]
        tr = np.trace(p[:3, :3])
        qw = np.sqrt(max(0.0, 1 + tr)) / 2
        qx = (p[2, 1] - p[1, 2]) / (4 * qw)
        qy = (p[0, 2] - p[2, 0]) / (4 * qw)
        qz = (p[1, 0] - p[0, 1]) / (4 * qw)
        gt_rows.append(f"{ns},{p[0,3]},{p[1,3]},{p[2,3]},{qw},{qx},{qy},{qz}")
    (gt_dir / "data.csv").write_text("\n".join(gt_rows))

    seq = datasets.load_euroc(str(tmp_path), calib=calib)
    assert len(seq.paths_l) == n
    assert seq.gt_poses is not None and len(seq.gt_poses) == n
    assert seq.timestamps[0] > 1e9  # really epoch-scale

    cfg = Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_kf_window=4, n_kf_max=32,
                           n_map_pt=2048, n_map_ln=512,
                           n_obs_pt=1024, n_obs_ln=256, vocab_k=128),
        orb=OrbParams(nlevels=2), camera=seq.cam)
    slam = SLAMSystem(cfg)
    try:
        loader = native_loader.StereoLoader(
            seq.paths_l, seq.paths_r, seq.cam.width, seq.cam.height,
            maps=(maps.map_x_l, maps.map_y_l, maps.map_x_r, maps.map_y_r))
        imgs = [(il, ir) for _, il, ir in loader]
    except RuntimeError:
        # native loader unbuilt in this environment: decode via cv2 +
        # device remap (the same rectification path run_slam uses)
        from gfplslam_tpu.ops.camera import rectify_pair
        imgs = []
        for pl, pr in zip(seq.paths_l, seq.paths_r):
            pair = jnp.asarray(np.stack(
                [cv2.imread(pl, cv2.IMREAD_GRAYSCALE).astype(np.float32),
                 cv2.imread(pr, cv2.IMREAD_GRAYSCALE).astype(np.float32)]))
            rec = np.asarray(rectify_pair(pair, maps))
            imgs.append((rec[0], rec[1]))
    il = np.stack([a for a, _ in imgs])
    ir = np.stack([b for _, b in imgs])
    slam.run_sequence(il, ir, seq.timestamps, chunk=5)
    slam.finish()
    assert not slam.vo.lost
    assert len(slam.vo.records) == n
    est = slam.all_frame_trajectory
    # GT association + ATE: the loaded epoch timestamps must line up
    keep, gtp = datasets.associate_gt(
        np.asarray([r.timestamp for r in slam.vo.records]),
        seq.gt_timestamps, seq.gt_poses)
    assert len(keep) == n
    rmse = ate_rmse(est[keep], gtp)
    assert rmse < 0.1, rmse
