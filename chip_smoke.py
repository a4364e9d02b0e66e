"""Smoke run of the stereo PL-SLAM main path on one NVIDIA GPU.

Drives the engine once through the entry points a user calls, at the full
EuRoC operating point (752x480 stereo, default ``CapacityParams``, 4 ORB
levels), in ONE process, and checks every result:

1. kernels: the fused FAST-9 score kernel and the Hamming matrix, compiled
   for the card at the main path's widths, against the plain XLA
   formulation and independent NumPy references;
2. VO: ``run_vo_scan`` on the 48-frame EuRoC and 16-frame KITTI worlds;
3. SLAM: ``SLAMSystem.run_sequence`` + ``finish`` on the 121-frame circuit
   with and without loop closure, then one global BA;
4. interactive: ``apps.run_slam.main`` (per-frame ``SLAMSystem.process``);
5. front end on the card against the same program on the host CPU.

Usage:
  python chip_smoke.py          # one card, all phases
  python chip_smoke.py --four   # four cards: distributed BA + batch VO only

It exits non-zero when JAX finds no GPU (there is no CPU fallback) or when
any phase fails. The last line of standard output is a JSON object
``{"ok": true, "device": {...}}``, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

from gfplslam_tpu.utils.device import card_info, require_gpu

# ---- pass bounds --------------------------------------------------------
# The measured C++ reference scored 0.514 m on this kind of world
# (BASELINE.md); the engine is held to a tighter bound.
VO_EUROC_ATE_MAX = 0.35
SLAM_LC_ATE_MAX = 0.20
# Front end, card vs host CPU. bf16 FAST margins (ops/fast.py) and the bf16
# banded blur (ops/pyramid.py) are rounded by each backend's own fusion, so
# a corner whose score sits at the threshold can flip between the two.
FRONTEND_COUNT_RTOL = 0.02
FRONTEND_MATCH_PX = 0.05
FRONTEND_MATCH_FRAC = 0.98
# --four: sharded vs single-card BA, batched vs per-sequence VO.
FOUR_BA_POS_TOL = 1e-3      # metres
FOUR_BA_ROT_TOL = 1e-3      # radians
FOUR_VO_POSE_TOL = 1e-4

EUROC_LEVEL1 = (400, 627)   # level_shapes(480, 752, 4, 1.2)[1]


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def u8(imgs) -> np.ndarray:
    """Quantize rendered frames to the uint8 camera-byte contract."""
    return np.clip(np.round(np.asarray(imgs)), 0, 255).astype(np.uint8)


def render(world, n: int, noise: float):
    from gfplslam_tpu.io import synthetic
    fr = [synthetic.render_frame(world, i, noise=noise) for i in range(n)]
    return u8(np.stack([f[0] for f in fr])), u8(np.stack([f[1] for f in fr]))


def kitti_camera():
    from gfplslam_tpu.config import CameraParams
    return CameraParams(width=1241, height=376, fx=718.856, fy=718.856,
                        cx=607.1928, cy=185.2157, baseline=0.537165719)


# ---- independent references ---------------------------------------------

def fast_score_reference(img: np.ndarray, threshold: float) -> np.ndarray:
    """FAST-9 arc score per pixel, straight from its definition: for each of
    the 16 arcs of 9 consecutive circle pixels, the smallest margin by which
    all 9 are brighter (or all darker) than the centre by more than the
    threshold; the score is the largest such margin, 0 where no arc passes
    and within 3 px of the border."""
    from gfplslam_tpu.ops.fast import ARC_LEN, FAST_CIRCLE
    img = np.asarray(img, np.float32)
    h, w = img.shape
    c = img[3:h - 3, 3:w - 3]
    d = np.stack([img[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] - c
                  for dx, dy in FAST_CIRCLE])
    t = np.float32(threshold)
    best = np.zeros_like(c)
    for sign in (1.0, -1.0):
        m = np.where(sign * d > t, sign * d - t, -np.inf).astype(np.float32)
        for k in range(16):
            arc = [(k + i) % 16 for i in range(ARC_LEN)]
            best = np.maximum(best, m[arc].min(axis=0))
    out = np.zeros((h, w), np.float32)
    out[3:h - 3, 3:w - 3] = best
    return out


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint32)


def hamming_reference(a: np.ndarray, b: np.ndarray,
                      rows: int = 128) -> np.ndarray:
    """[N, W] x [M, W] uint32 Hamming distances by byte-table popcount."""
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    out = np.empty((a.shape[0], b.shape[0]), np.uint32)
    for s in range(0, a.shape[0], rows):
        x = a[s:s + rows, None, :] ^ b[None, :, :]
        out[s:s + rows] = _POP8[x.view(np.uint8)].reshape(
            x.shape[0], x.shape[1], -1).sum(-1)
    return out


# ---- phases ---------------------------------------------------------------

def kernel_phase(fast_shapes, hamming_shapes, seed: int = 0) -> dict:
    """Compile the FAST score map and the Hamming matrix at the given widths
    and compare each with its references. ``fast_shapes`` entries are (H, W)
    for one image or (C, L, H, W) for C cameras x L padded levels, vmapped
    as in the front end. ``fast_score_map`` (the fused Triton kernel on the
    GPU) must equal the NumPy arc-score definition on integer intensities,
    and the plain XLA formulation on integer and on blurred (non-integer)
    intensities, bit for bit. Hamming must equal a byte-table popcount."""
    import jax
    import jax.numpy as jnp
    from gfplslam_tpu.ops.fast import fast_score_map, fast_score_map_xla
    from gfplslam_tpu.ops.hamming import hamming_matrix

    def batched(fn, ndim):
        for _ in range(ndim - 2):
            fn = jax.vmap(fn, in_axes=(0, None))
        return jax.jit(fn)

    rng = np.random.default_rng(seed)
    out = {}
    th = jnp.asarray(20.0)
    for shape in fast_shapes:
        img = rng.integers(0, 256, shape).astype(np.float32)
        kern = batched(fast_score_map, len(shape))
        plain = batched(fast_score_map_xla, len(shape))
        got = np.asarray(kern(jnp.asarray(img), th))
        flat = img.reshape(-1, *shape[-2:])
        ref = np.stack([fast_score_reference(x, float(th)) for x in flat]
                       ).reshape(got.shape)
        assert (ref > 0).any()
        blurred = jnp.asarray(img * 0.37)
        res = {"vs_numpy": int((got != ref).sum()),
               "vs_xla": int((got != np.asarray(
                   plain(jnp.asarray(img), th))).sum()),
               "vs_xla_blurred": int((np.asarray(kern(blurred, th))
                                      != np.asarray(plain(blurred, th))
                                      ).sum())}
        out[f"fast{tuple(shape)}"] = res
        assert set(res.values()) == {0}, f"FAST {shape}: {res}"
    for n, m in hamming_shapes:
        a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
        got = np.asarray(jax.jit(hamming_matrix)(jnp.asarray(a),
                                                 jnp.asarray(b)))
        bad = int((got != hamming_reference(a, b)).sum())
        out[f"hamming{(n, m)}"] = bad
        assert bad == 0, f"Hamming {n}x{m}: {bad} entries differ"
    return out


def vo_phase(cfg, n_frames: int, seed: int, ate_max: float | None = None,
             n_points: int = 900, n_lines: int = 90) -> dict:
    """``run_vo_scan`` over a rendered forward-motion world: compile (first
    call) and steady-state (second call) seconds, ATE."""
    import jax.numpy as jnp
    from gfplslam_tpu.io import synthetic
    from gfplslam_tpu.models.vo import run_vo_scan
    from gfplslam_tpu.utils.trajectory import ate_rmse

    world = synthetic.make_world(n_frames=n_frames, n_points=n_points,
                                 n_lines=n_lines, seed=seed, cam=cfg.camera,
                                 motion="forward")
    il, ir = render(world, n_frames, noise=1.5)
    il, ir = jnp.asarray(il), jnp.asarray(ir)
    ts = jnp.asarray(world.timestamps.astype(np.float32))
    t0 = time.perf_counter()
    poses, _ = run_vo_scan(cfg, il, ir, ts)
    poses.block_until_ready()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    poses, aux = run_vo_scan(cfg, il, ir, ts)
    poses.block_until_ready()
    run_s = time.perf_counter() - t0
    p = np.asarray(poses)
    assert p.shape == (n_frames, 4, 4) and np.all(np.isfinite(p))
    ate = float(ate_rmse(p, world.poses))
    res = {"frames": n_frames, "compile_s": compile_s, "run_s": run_s,
           "fps": (n_frames - 1) / run_s, "ate_m": ate,
           "keyframes": int(np.asarray(aux["is_kf"]).sum()) + 1}
    if ate_max is not None:
        assert ate <= ate_max, f"VO ATE {ate:.4f} m > {ate_max} m"
    return res


def slam_phase(cfg, n_frames: int = 121, chunk: int = 24,
               seed: int = 11) -> dict:
    """Streaming SLAM on the circuit world with and without loop closure,
    then one global BA on the loop-closed map and XLA's memory analysis of
    that program (the largest the engine compiles)."""
    from gfplslam_tpu.io import synthetic
    from gfplslam_tpu.models.slam import SLAMSystem
    from gfplslam_tpu.utils.trajectory import ate_rmse

    world = synthetic.make_world(n_frames=n_frames, n_points=900,
                                 n_lines=90, seed=seed, motion="circuit",
                                 cam=cfg.camera, textured=True)
    il, ir = render(world, n_frames, noise=1.0)
    ts = np.asarray(world.timestamps)

    res = {"frames": n_frames}
    for lc in (True, False):
        s = SLAMSystem(cfg, run_loop_closure=lc)
        t0 = time.perf_counter()
        s.run_sequence(il, ir, ts, chunk=chunk)
        s.finish()
        wall = time.perf_counter() - t0
        traj = s.all_frame_trajectory
        assert np.all(np.isfinite(traj))
        key = "lc" if lc else "no_lc"
        res[f"{key}_wall_s"] = wall
        res[f"ate_{key}_m"] = float(ate_rmse(traj, world.poses))
        res[f"{key}_keyframes"] = len(s.keyframe_trajectory)
        res[f"{key}_loop_closures"] = s.n_loop_closures
        res[f"{key}_lost"] = bool(s.vo.lost)
        assert not s.vo.lost, f"track lost (lc={lc})"
        if lc:
            slam_lc = s
    assert res["lc_loop_closures"] >= 1, "no loop closure"
    assert res["ate_lc_m"] < res["ate_no_lc_m"], (
        f"LC ATE {res['ate_lc_m']:.4f} not below no-LC "
        f"{res['ate_no_lc_m']:.4f}")
    assert res["ate_lc_m"] <= SLAM_LC_ATE_MAX, (
        f"LC ATE {res['ate_lc_m']:.4f} m > {SLAM_LC_ATE_MAX} m")

    t0 = time.perf_counter()
    slam_lc.finish(run_global_ba=True)
    kf = slam_lc.keyframe_trajectory
    res["global_ba_s"] = time.perf_counter() - t0
    assert np.all(np.isfinite(kf))
    res["ate_lc_global_ba_m"] = float(
        ate_rmse(slam_lc.all_frame_trajectory, world.poses))
    res["global_ba_memory"] = global_ba_memory(cfg, slam_lc)
    return res


def global_ba_memory(cfg, slam) -> str:
    """XLA's memory analysis of the global-BA program on ``slam``'s map."""
    from gfplslam_tpu.models import ba as ba_ops
    from gfplslam_tpu.models import map as map_ops
    prob = map_ops.build_local_ba_problem(cfg, slam.map, global_ba=True)[0]
    lowered = ba_ops.solve_ba.lower(
        cfg.camera, prob, lambda0=cfg.slam.lambda_lba_lm,
        lambda_k=cfg.slam.lambda_lba_k, max_iters=cfg.slam.max_iters_lba)
    return str(lowered.compile().memory_analysis())


def interactive_phase(frames: int = 30, small: bool = False) -> dict:
    """``apps.run_slam.main`` in this process (a child would be a second
    process on the card): the per-frame ``SLAMSystem.process`` path."""
    from gfplslam_tpu.apps import run_slam
    with tempfile.TemporaryDirectory(prefix="gfplslam_smoke_") as out_dir:
        argv = ["--synthetic", "--frames", str(frames),
                "-o", os.path.join(out_dir, "run")]
        if small:
            argv.append("--small")
        t0 = time.perf_counter()
        summary = run_slam.main(argv)
        summary["wall_s"] = time.perf_counter() - t0
    assert not summary["lost"], "interactive run lost track"
    assert np.isfinite(summary.get("ate_rmse", np.nan)), summary
    return summary


def match_fraction(xy_a: np.ndarray, xy_b: np.ndarray, tol: float) -> float:
    """Share of points in ``xy_a`` with a point of ``xy_b`` within ``tol``
    pixels."""
    if len(xy_a) == 0:
        return 1.0 if len(xy_b) == 0 else 0.0
    if len(xy_b) == 0:
        return 0.0
    d2 = ((xy_a[:, None, :] - xy_b[None, :, :]) ** 2).sum(-1)
    return float((d2.min(axis=1) <= tol * tol).mean())


def frontend_compare(cfg, dev_a, dev_b, seed: int = 2) -> dict:
    """``process_stereo_pair`` on two devices on the same rendered pair:
    keypoint and line counts within ``FRONTEND_COUNT_RTOL`` and keypoint
    positions matched within ``FRONTEND_MATCH_PX`` for at least
    ``FRONTEND_MATCH_FRAC`` of them (see the bound's comment for why the
    two backends may differ at all)."""
    import jax
    import jax.numpy as jnp
    from gfplslam_tpu.io import synthetic
    from gfplslam_tpu.models.frame import process_stereo_pair

    world = synthetic.make_world(n_frames=2, n_points=300, n_lines=40,
                                 seed=seed, cam=cfg.camera)
    il, ir = render(world, 1, noise=1.0)
    outs = []
    for dev in (dev_a, dev_b):
        a = jax.device_put(jnp.asarray(il[0]), dev)
        b = jax.device_put(jnp.asarray(ir[0]), dev)
        th = jax.device_put(jnp.asarray(20.0), dev)
        f = process_stereo_pair(a, b, cfg, th)
        v = np.asarray(f.feat_l.pt_valid)
        outs.append({"xy": np.asarray(f.feat_l.pt_xy)[v],
                     "n_kp": int(v.sum()),
                     "n_ln": int(np.asarray(f.feat_l.ln_valid).sum()),
                     "n_stereo_pt": int(np.asarray(f.points.valid).sum()),
                     "n_stereo_ln": int(np.asarray(f.lines.valid).sum())})
    a, b = outs
    res = {k: (a[k], b[k]) for k in ("n_kp", "n_ln", "n_stereo_pt",
                                      "n_stereo_ln")}
    for k in ("n_kp", "n_ln"):
        ref = max(b[k], 1)
        assert abs(a[k] - b[k]) <= FRONTEND_COUNT_RTOL * ref, (k, res[k])
    res["kp_match_frac"] = match_fraction(a["xy"], b["xy"],
                                          FRONTEND_MATCH_PX)
    assert res["kp_match_frac"] >= FRONTEND_MATCH_FRAC, res
    assert a["n_kp"] > 0
    return res


# ---- four cards -----------------------------------------------------------

def pose_diff(pa: np.ndarray, pb: np.ndarray) -> tuple[float, float]:
    """Largest translation (m) and rotation (rad) difference between two
    stacks of 4x4 poses."""
    dt = np.linalg.norm(pa[..., :3, 3] - pb[..., :3, 3], axis=-1).max()
    r = np.einsum("...ji,...jk->...ik", pa[..., :3, :3], pb[..., :3, :3])
    cos = np.clip((np.trace(r, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return float(dt), float(np.arccos(cos).max())


def four_ba_compare(mesh, n_kf: int, n_pt: int, n_ln: int,
                    single_device, max_iters: int = 20) -> dict:
    """Landmark-sharded BA on ``mesh`` against ``solve_ba`` on one device,
    on ``bench_dist_ba.make_problem``. Both run the full ``max_iters``
    budget (``tol=0``): the convergence exit compares error sums that the
    two solvers add in different orders, so near convergence it can stop
    them at different iterations (13 against 18 on four H100s with the
    default tolerance, poses still within 3e-5 m)."""
    import jax
    from gfplslam_tpu.apps.bench_dist_ba import make_problem
    from gfplslam_tpu.config import CameraParams
    from gfplslam_tpu.models import ba as ba_ops
    from gfplslam_tpu.parallel import dist_ba

    cam = CameraParams()
    prob = make_problem(n_kf, n_pt, n_ln, cam, seed=0)
    n = mesh.devices.size
    sharded = dist_ba.shard_problem_by_landmark(prob, n)
    t0 = time.perf_counter()
    res_d = dist_ba.solve_ba_sharded(cam, sharded, mesh, max_iters=max_iters,
                                     tol=0.0)
    jax.block_until_ready(res_d.kf_pose)
    t_dist = time.perf_counter() - t0
    prob_1 = jax.device_put(prob, single_device)
    t0 = time.perf_counter()
    res_s = ba_ops.solve_ba(cam, prob_1, max_iters=max_iters, tol=0.0)
    jax.block_until_ready(res_s.kf_pose)
    t_single = time.perf_counter() - t0
    dpos, drot = pose_diff(np.asarray(res_d.kf_pose),
                           np.asarray(res_s.kf_pose))
    out = {"kf_pos_diff_m": dpos, "kf_rot_diff_rad": drot,
           "iters_sharded": int(res_d.iters),
           "iters_single": int(res_s.iters),
           "first_call_s_sharded": t_dist, "first_call_s_single": t_single}
    assert dpos <= FOUR_BA_POS_TOL and drot <= FOUR_BA_ROT_TOL, out
    assert out["iters_sharded"] == out["iters_single"], out
    return out


def four_vo_compare(cfg, mesh, n_seq: int, n_frames: int,
                    single_device) -> dict:
    """``run_vo_batch`` of ``n_seq`` sequences over ``mesh`` against each
    sequence's ``run_vo_scan`` on one device."""
    import jax
    import jax.numpy as jnp
    from gfplslam_tpu.io import synthetic
    from gfplslam_tpu.models.vo import run_vo_scan
    from gfplslam_tpu.parallel.batch import run_vo_batch

    il, ir, ts = [], [], []
    for s in range(n_seq):
        w = synthetic.make_world(n_frames=n_frames, n_points=900,
                                 n_lines=90, seed=40 + s, cam=cfg.camera)
        a, b = render(w, n_frames, noise=1.5)
        il.append(a)
        ir.append(b)
        ts.append(w.timestamps.astype(np.float32))
    il, ir, ts = np.stack(il), np.stack(ir), np.stack(ts)
    t0 = time.perf_counter()
    poses_b, _ = run_vo_batch(cfg, jnp.asarray(il), jnp.asarray(ir),
                              jnp.asarray(ts), mesh=mesh)
    poses_b = np.asarray(poses_b)
    t_batch = time.perf_counter() - t0
    diffs = []
    for s in range(n_seq):
        args = [jax.device_put(jnp.asarray(x[s]), single_device)
                for x in (il, ir, ts)]
        p, _ = run_vo_scan(cfg, *args)
        diffs.append(float(np.abs(np.asarray(p) - poses_b[s]).max()))
    out = {"max_pose_diff": max(diffs), "per_seq": diffs,
           "first_call_s_batch": t_batch}
    assert np.all(np.isfinite(poses_b))
    assert out["max_pose_diff"] <= FOUR_VO_POSE_TOL, out
    return out


# ---- driver ---------------------------------------------------------------

def run_phase(name: str, fn, results: dict, failed: list, device) -> None:
    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception:  # reported and counted: the script still fails
        traceback.print_exc()
        failed.append(name)
        log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
        return
    wall = time.perf_counter() - t0
    results[name] = res
    log(f"[{name}] ok wall_s={wall:.2f} peak_bytes={peak_bytes(device)} "
        f"{json.dumps(res, default=str)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: distributed BA and batch VO against "
                         "one card, and no other phase")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    require_gpu(devices)
    dev = devices[0]
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devices)}")
    log(f"card: {card_info()}")
    # the package sets "highest" at import: the 6x6 and SE(3) algebra needs
    # true fp32 products, not TF32
    precision = jax.config.jax_default_matmul_precision
    log(f"jax_default_matmul_precision: {precision}")

    from gfplslam_tpu.config import CameraParams, Config, SlamParams
    results, failed = {}, []
    if precision != "highest":
        failed.append("matmul_precision")

    t_all = time.perf_counter()
    if args.four:
        if len(devices) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
        from gfplslam_tpu.parallel import dist_ba
        mesh = dist_ba.make_mesh(4)
        run_phase("four_dist_ba", lambda: four_ba_compare(
            mesh, 16, 8064, 1008, dev), results, failed, dev)
        run_phase("four_batch_vo", lambda: four_vo_compare(
            Config(camera=CameraParams()), mesh, 4, 8, dev),
            results, failed, dev)
    else:
        euroc = Config(camera=CameraParams(),
                       slam=SlamParams(lc_kf_dist=12, lc_kf_max_dist=6))
        kitti = Config(camera=kitti_camera())
        h1, w1 = EUROC_LEVEL1
        run_phase("kernels", lambda: kernel_phase(
            [(480, 752), (2, 3, h1, w1), (376, 1241), (2, 3, 313, 1034)],
            [(1024, 1024), (512, 512), (1024, 16384)]),
            results, failed, dev)
        run_phase("vo_euroc", lambda: vo_phase(
            euroc, 48, seed=3, ate_max=VO_EUROC_ATE_MAX),
            results, failed, dev)
        run_phase("vo_kitti", lambda: vo_phase(kitti, 16, seed=7),
                  results, failed, dev)
        run_phase("slam", lambda: slam_phase(euroc), results, failed, dev)
        run_phase("interactive", lambda: interactive_phase(30),
                  results, failed, dev)
        from __graft_entry__ import small_config
        run_phase("frontend_vs_cpu", lambda: frontend_compare(
            small_config(), dev, jax.devices("cpu")[0]), results, failed, dev)
    log(f"total_wall_s={time.perf_counter() - t_all:.1f} "
        f"peak_bytes={peak_bytes(dev)}")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
