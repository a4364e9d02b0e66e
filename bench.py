"""Benchmark: stereo VO + full-SLAM frames/s on one GPU at the EuRoC operating point.

Primary metric: the full per-frame tracking pipeline (front-end + cross-frame
matching + line cutting + pose optimization) on synthetic EuRoC-resolution
stereo pairs (752x480, 1000-point/300-line budgets — BASELINE.md operating
point) as ONE on-device ``lax.scan`` over the sequence (zero host round-trips
per frame): steady-state VO frames per second on one GPU. MEDIAN of
``REPS`` timed repetitions.

Needs an NVIDIA GPU: it exits non-zero without one, and names the card
(platform, device kind and count, nvidia-smi name and power limit) in its
JSON line.

Also measured and reported in the same JSON line:
- ``full_slam_fps``: the SHIPPED streaming driver — ``SLAMSystem.run_sequence``
  (uint8 camera bytes, double-buffered host->device upload, 24-frame scan
  chunks sharing ONE compiled shape, per-KF fused mapping, loop closure ON
  and FIRING) timed end-to-end over a 121-frame textured loop sequence.
  Median of ``REPS`` runs; ``full_slam_spread`` = (max-min)/median.
- ``n_loop_closures`` / ``ate_rmse`` / ``ate_rmse_no_lc``: the loop-closure
  evidence — the same sequence with LC on vs off, on an out-and-back
  "circuit" world whose revisit is discriminative (conf ~1.4 for the true
  revisit vs ~1.0 aliased; wrong-place candidates are proposed and rejected
  by geometric verification, the reference's own containment). The
  reference's lc_kf_dist=100 / lc_kf_max_dist=20 gates (config.cpp:69-70)
  assume hundreds of KFs between revisits; this world revisits after ~38
  KFs, so the gates scale to 12/6 (same "exclude the temporally-near
  third of the trajectory" + "dispersion radius ~ gate/2" semantics).
- ``kf_mapping_ms``: per-KF cost of the fused mapping program alone.
- ``ba_ms_per_iter``: one local-BA LM iteration at the shipped window shape
  (BASELINE.json metric 3: "BA ms/iter at N keyframes").
- ``compile_s``: wall seconds of the cold warmup pass (XLA compiles +
  first execution; persistent cache hides most of it on later runs).

``vs_baseline``: the reference publishes no fps numbers (BASELINE.md); the
EuRoC camera rate (20 Hz) is the real-time baseline the reference claims to
meet, i.e. vs_baseline = fps / 20.0.
"""

import json
import statistics
import time

import numpy as np

REPS = 3


def _u8(imgs):
    """Quantize the float renderer output to the uint8 camera-byte contract
    (real EuRoC/KITTI images are 8-bit; the engine casts on device)."""
    return np.clip(np.round(np.asarray(imgs)), 0, 255).astype(np.uint8)


def main():
    import jax
    import jax.numpy as jnp
    from gfplslam_tpu.utils.device import device_record, require_gpu
    require_gpu(jax.devices())
    from gfplslam_tpu.config import Config, CameraParams, SlamParams
    from gfplslam_tpu.io import synthetic
    from gfplslam_tpu.models.vo import run_vo_scan
    from gfplslam_tpu.models import loop as loop_ops
    from gfplslam_tpu.models import map as map_ops
    from gfplslam_tpu.models.mapping import mapping_step

    cam = CameraParams()  # EuRoC rectified 752x480
    # ONE Config for every EuRoC section (each distinct Config retraces the
    # big programs). lc_kf_dist scaled to the bench loop period — see module
    # docstring; it does not enter the VO/BA programs' math.
    cfg = Config(camera=cam, slam=SlamParams(lc_kf_dist=12, lc_kf_max_dist=6))

    n_frames = 48
    world = synthetic.make_world(n_frames=n_frames, n_points=900, n_lines=90,
                                 seed=3, cam=cam)
    frames = [synthetic.render_frame(world, i, noise=1.5)
              for i in range(n_frames)]
    imgs_l = jnp.asarray(_u8(np.stack([f[0] for f in frames])))
    imgs_r = jnp.asarray(_u8(np.stack([f[1] for f in frames])))
    ts = jnp.asarray(world.timestamps.astype(np.float32))

    # ---- VO tracking throughput (scan, zero host round-trips) ----
    compile_t0 = time.perf_counter()
    poses, aux = run_vo_scan(cfg, imgs_l, imgs_r, ts)  # warmup / compile
    poses.block_until_ready()
    compile_vo_s = time.perf_counter() - compile_t0

    fps_samples = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        poses, aux = run_vo_scan(cfg, imgs_l, imgs_r, ts)
        poses.block_until_ready()
        fps_samples.append((n_frames - 1) / (time.perf_counter() - t0))
    fps = statistics.median(fps_samples)
    kf_interval = max(1.0, (n_frames - 1) / max(
        1, int(np.asarray(aux["is_kf"]).sum())))

    # ---- fused per-KF mapping pipeline on a growing map ----
    from gfplslam_tpu.models.frame import process_stereo_pair
    fr = [process_stereo_pair(imgs_l[i], imgs_r[i], cfg, jnp.asarray(20.0))
          for i in range(n_frames)]
    t_rel = jnp.eye(4).at[2, 3].set(0.04)

    m = map_ops.initialize_map(cfg, map_ops.empty_map(cfg), fr[0])
    ls = loop_ops.insert_kf_bow(cfg, loop_ops.empty_loop_state(cfg),
                                jnp.asarray(0), fr[0])
    # warmup/compile + grow the map to steady occupancy over distinct KFs
    for i in range(1, 9):
        res = mapping_step(cfg, m, ls, fr[i], t_rel)
        m, ls = res.map, res.loop_state
    jax.block_until_ready(m)

    kf_ms_samples = []
    for r in range(REPS):
        kf_reps = 10
        t0 = time.perf_counter()
        for i in range(kf_reps):
            res = mapping_step(cfg, m, ls, fr[9 + (10 * r + i) % 15], t_rel)
            m, ls = res.map, res.loop_state
        jax.block_until_ready(m)
        kf_ms_samples.append((time.perf_counter() - t0) / kf_reps * 1000.0)
    kf_ms = statistics.median(kf_ms_samples)

    # ---- BA ms/iter at the shipped local-window shape (BASELINE.json
    # metric 3) — solve on the occupied map's window problem ----
    from gfplslam_tpu.models import ba as ba_ops
    prob = map_ops.build_local_ba_problem(cfg, m)[0]
    res_ba = ba_ops.solve_ba(cfg.camera, prob, max_iters=10)
    jax.block_until_ready(res_ba.err)
    ba_samples = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        res_ba = ba_ops.solve_ba(cfg.camera, prob, max_iters=10)
        jax.block_until_ready(res_ba.err)
        ba_iters = max(1, int(res_ba.iters))
        ba_samples.append((time.perf_counter() - t0) / ba_iters * 1e3)
    ba_ms_per_iter = statistics.median(ba_samples)

    # ---- full SLAM: the SHIPPED streaming driver end-to-end on a
    # 121-frame textured loop (120 scanned frames = 5 chunks x 24 sharing
    # ONE compiled scan shape), uint8 bytes, double-buffered upload, loop
    # closure on AND firing (gates scaled to the loop period — docstring).
    from gfplslam_tpu.models.slam import SLAMSystem
    from gfplslam_tpu.utils.trajectory import ate_rmse
    n_slam = 121
    chunk = 24
    slam_world = synthetic.make_world(n_frames=n_slam, n_points=900,
                                      n_lines=90, seed=11, motion="circuit",
                                      cam=cam, textured=True)
    slam_frames = [synthetic.render_frame(slam_world, i, noise=1.0)
                   for i in range(n_slam)]
    sl_l = _u8(np.stack([f[0] for f in slam_frames]))
    sl_r = _u8(np.stack([f[1] for f in slam_frames]))
    sl_ts = np.asarray(slam_world.timestamps)

    def run_full(lc=True):
        s = SLAMSystem(cfg, run_loop_closure=lc)
        t0 = time.perf_counter()
        s.run_sequence(sl_l, sl_r, sl_ts, chunk=chunk)
        s.finish()
        return s, time.perf_counter() - t0

    compile_t0 = time.perf_counter()
    warm, _ = run_full(lc=True)          # compiles scan + mapping + PGO
    compile_slam_s = time.perf_counter() - compile_t0

    slam_samples = []
    for _ in range(REPS):
        slam, dt = run_full(lc=True)
        slam_samples.append(dt)
    full_fps = n_slam / statistics.median(slam_samples)
    spread = ((max(slam_samples) - min(slam_samples))
              / statistics.median(slam_samples))
    n_kf_grown = len(slam.keyframe_trajectory)
    n_lc = slam.n_loop_closures
    ate = float(ate_rmse(slam.all_frame_trajectory, slam_world.poses))
    slam_nolc, _ = run_full(lc=False)
    ate_no_lc = float(ate_rmse(slam_nolc.all_frame_trajectory,
                               slam_world.poses))

    # per-frame driver throughput (same engine, interactive dispatch mode)
    pf = SLAMSystem(cfg)
    for i in range(3):
        pf.process(sl_l[i], sl_r[i], float(sl_ts[i]))
    t0 = time.perf_counter()
    n_pf = 30
    for i in range(3, 3 + n_pf):
        pf.process(sl_l[i], sl_r[i], float(sl_ts[i]))
    pf_fps = n_pf / (time.perf_counter() - t0)

    # ---- KITTI operating point (1241x376, 10 Hz camera,
    # config/kitti/kitti00-02.yaml) — a distinct compile shape ----
    kcam = CameraParams(width=1241, height=376, fx=718.856, fy=718.856,
                        cx=607.1928, cy=185.2157, baseline=0.537165719)
    kcfg = Config(camera=kcam)
    kworld = synthetic.make_world(n_frames=16, n_points=900, n_lines=90,
                                  seed=7, cam=kcam, motion="forward")
    kframes = [synthetic.render_frame(kworld, i, noise=1.5)
               for i in range(16)]
    k_l = jnp.asarray(_u8(np.stack([f[0] for f in kframes])))
    k_r = jnp.asarray(_u8(np.stack([f[1] for f in kframes])))
    k_ts = jnp.asarray(kworld.timestamps.astype(np.float32))
    kposes, _ = run_vo_scan(kcfg, k_l, k_r, k_ts)
    kposes.block_until_ready()
    k_samples = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        kposes, _ = run_vo_scan(kcfg, k_l, k_r, k_ts)
        kposes.block_until_ready()
        k_samples.append(15 / (time.perf_counter() - t0))
    kitti_fps = statistics.median(k_samples)

    print(json.dumps({
        "metric": "euroc_stereo_vo_frames_per_s_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 20.0, 3),
        "full_slam_fps": round(full_fps, 3),
        "full_slam_spread": round(spread, 3),
        "slam_per_frame_fps": round(pf_fps, 3),
        "kf_mapping_ms": round(kf_ms, 3),
        "ba_ms_per_iter": round(ba_ms_per_iter, 3),
        "ate_rmse": round(ate, 4),
        "ate_rmse_no_lc": round(ate_no_lc, 4),
        "n_loop_closures": n_lc,
        "slam_keyframes": n_kf_grown,
        "kf_interval_frames": round(kf_interval, 2),
        "kitti_vo_fps": round(kitti_fps, 3),
        "compile_s": {"vo_scan": round(compile_vo_s, 1),
                      "slam_seq": round(compile_slam_s, 1)},
        "device": device_record(),
    }))


if __name__ == "__main__":
    main()
