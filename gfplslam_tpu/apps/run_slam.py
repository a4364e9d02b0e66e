"""CLI driver: full SLAM / VO on a dataset or synthetic sequence.

Parity with app/plslam_mod.cpp (main driver, :54-577) and plstvo_mod
(VO-only): runs the engine over a sequence, writes TUM all-frame + keyframe
trajectories and the per-frame TimeLog, and reports ATE when ground truth is
available. Supports the legacy drivers' -o/-n/-s frame offset/count/stride
flags (plslam_dataset.cpp:64-69).

Usage:
  python -m gfplslam_tpu.apps.run_slam --synthetic --frames 30 -o /tmp/out
  python -m gfplslam_tpu.apps.run_slam --euroc /data/MH_01_easy -o out
  python -m gfplslam_tpu.apps.run_slam --kitti /data/kitti/00 -o out --vo-only
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="stereo PL-SLAM driver")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", action="store_true")
    src.add_argument("--euroc", metavar="DIR")
    src.add_argument("--kitti", metavar="DIR")
    src.add_argument("--gazebo", metavar="DIR",
                     help="Gazebo simulation sequence (cam0/data + "
                          "cam1/data, gazebo_params.yaml rig)")
    ap.add_argument("-o", "--out", default="/tmp/gfplslam",
                    help="output prefix")
    ap.add_argument("-n", "--frames", type=int, default=0,
                    help="max frames (0 = all)")
    ap.add_argument("--offset", type=int, default=0, help="first frame")
    ap.add_argument("-s", "--stride", type=int, default=1)
    ap.add_argument("--vo-only", action="store_true",
                    help="tracking only, no mapping back-end (plstvo mode)")
    ap.add_argument("--no-lines", action="store_true")
    ap.add_argument("--no-loop-closure", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="reduced capacities (fast CPU runs)")
    ap.add_argument("--timing", action="store_true",
                    help="per-module TimeLog mode: one device program per "
                         "reference pipeline stage (all 10 time_* fields "
                         "populated; costs fusion)")
    ap.add_argument("--async-mapping", dest="async_mapping",
                    action="store_true", default=True,
                    help="dispatch per-KF BA/loop scoring without blocking "
                         "tracking (decisions land at the next KF; DEFAULT)")
    ap.add_argument("--sync", dest="async_mapping", action="store_false",
                    help="blocking mapping: BA/LC decisions land at the "
                         "same KF (the reference's synchronous addKeyFrame)")
    ap.add_argument("--multihost", action="store_true",
                    help="initialize jax.distributed from env coordinator "
                         "settings before touching devices")
    ap.add_argument("--chunk", type=int, default=0, metavar="N",
                    help="streaming chunk driver: track N frames per device "
                         "dispatch (throughput mode — amortizes host/device "
                         "round trips at N frames of latency)")
    args = ap.parse_args(argv)

    if args.multihost:
        from gfplslam_tpu.parallel.multihost import ensure_multihost
        ensure_multihost()

    from gfplslam_tpu.config import (CameraParams, CapacityParams, Config,
                                     OrbParams, StvoParams)
    from gfplslam_tpu.io import synthetic as synth
    from gfplslam_tpu.utils.trajectory import ate_rmse, write_tum

    # ---- source ----
    if args.synthetic:
        n = args.frames or 30
        world = synth.make_world(n_frames=n, seed=0)
        cam = world.cam
        def frames():
            for i in range(args.offset, n, args.stride):
                il, ir = synth.render_frame(world, i)
                yield world.timestamps[i], il, ir
        gt = world.poses[args.offset::args.stride]
        gt_ts = world.timestamps[args.offset::args.stride]
    else:
        from gfplslam_tpu.io.datasets import (load_euroc, load_gazebo,
                                              load_kitti)
        from gfplslam_tpu.io import native_loader
        seq = (load_euroc(args.euroc) if args.euroc
               else load_gazebo(args.gazebo) if args.gazebo
               else load_kitti(args.kitti))
        cam = seq.cam
        idx = range(args.offset,
                    len(seq.paths_l) if not args.frames
                    else min(args.offset + args.frames, len(seq.paths_l)),
                    args.stride)
        paths_l = [seq.paths_l[i] for i in idx]
        paths_r = [seq.paths_r[i] for i in idx]
        ts_sel = [seq.timestamps[i] for i in idx]
        maps = None
        if seq.maps is not None:
            maps = (seq.maps.map_x_l, seq.maps.map_y_l,
                    seq.maps.map_x_r, seq.maps.map_y_r)
        loader = native_loader.StereoLoader(
            paths_l, paths_r, cam.width, cam.height, maps=maps,
            n_threads=4, queue_depth=6)
        def frames():
            for k, il, ir in loader:
                yield ts_sel[k], il, ir
        gt, gt_ts = seq.gt_poses, seq.gt_timestamps

    cfg = Config(
        camera=cam,
        cap=(CapacityParams(n_pt=256, n_ln=128) if args.small
             else CapacityParams()),
        orb=(OrbParams(nlevels=2) if args.small else OrbParams()),
        stvo=StvoParams(has_lines=not args.no_lines),
    )

    # ---- engine ----
    if args.timing:
        from gfplslam_tpu.models.timed_vo import TimedVO
        vo = TimedVO(cfg)
    else:
        from gfplslam_tpu.models.vo import VisualOdometry
        vo = VisualOdometry(cfg)
    if args.vo_only:
        engine = vo
        process = engine.process
    else:
        from gfplslam_tpu.models.slam import SLAMSystem
        engine = SLAMSystem(cfg, vo=vo,
                            run_loop_closure=not args.no_loop_closure,
                            async_mapping=args.async_mapping)
        process = engine.process

    t0 = time.perf_counter()
    n_done = 0
    if args.chunk and not args.vo_only:
        # streaming chunk driver (SLAMSystem.process_chunk): one tracking
        # dispatch + one host transfer per N frames
        buf = []
        first_chunk = True
        for ts, il, ir in frames():
            buf.append((float(ts), il, ir))
            # the first chunk carries one extra frame (frame 0 is consumed
            # by map init) so every scan is exactly args.chunk long — ONE
            # compiled scan shape for the whole sequence
            if len(buf) >= args.chunk + (1 if first_chunk else 0):
                first_chunk = False
                engine.process_chunk(
                    np.stack([b[1] for b in buf]),
                    np.stack([b[2] for b in buf]),
                    np.asarray([b[0] for b in buf]))
                n_done += len(buf)
                buf = []
                print(f"frame {n_done}: kf_total="
                      f"{len(engine.kf_timestamps)}", file=sys.stderr)
                if engine.vo.lost:
                    print("TRACK LOST — terminating early", file=sys.stderr)
                    break
        if buf and not engine.vo.lost:
            engine.process_chunk(
                np.stack([b[1] for b in buf]),
                np.stack([b[2] for b in buf]),
                np.asarray([b[0] for b in buf]))
            n_done += len(buf)
        engine.finish()
    else:
        for ts, il, ir in frames():
            rec = process(il, ir, float(ts))
            n_done += 1
            if n_done % 10 == 0:
                print(f"frame {n_done}: kf={rec.is_kf} "
                      f"pt={rec.n_pt} ln={rec.n_ln}", file=sys.stderr)
            vo = engine if args.vo_only else engine.vo
            if vo.lost:
                print("TRACK LOST — terminating early "
                      "(max_num_frame_loss)", file=sys.stderr)
                break
        if not args.vo_only:
            engine.finish()
    wall = time.perf_counter() - t0

    # ---- outputs (plslam_mod.cpp:488-566 file set) ----
    # The KF trajectory comes from the *optimized map* poses and the
    # all-frame trajectory is re-based onto them (plslam_mod.cpp:538-566 +
    # mapHandler KF poses); VO-only mode writes raw odometry.
    vo = engine if args.vo_only else engine.vo
    if args.vo_only:
        traj = vo.trajectory
        kf_ts = [r.timestamp for r in vo.records if r.is_kf]
        kf_traj = np.stack([r.t_cam_w for r in vo.records if r.is_kf])
    else:
        traj = engine.all_frame_trajectory
        kf_ts = engine.kf_timestamps
        kf_traj = engine.keyframe_trajectory[:len(kf_ts)]
    write_tum(args.out + "_AllFrameTrajectory.txt", vo.timestamps, traj)
    write_tum(args.out + "_KeyFrameTrajectory.txt", kf_ts, kf_traj)
    vo.timelog.write(args.out + "_Log.txt")

    summary = {"frames": n_done, "fps": round(n_done / wall, 2),
               "keyframes": len(kf_ts), "lost": vo.lost}
    if gt is not None and len(gt):
        if args.synthetic:
            m = min(len(traj), len(gt))
            summary["ate_rmse"] = round(
                float(ate_rmse(traj[:m], gt[:m])), 4)
        else:
            from gfplslam_tpu.io.datasets import associate_gt
            keep, gtp = associate_gt(vo.timestamps, gt_ts, gt)
            if len(keep) > 3:
                summary["ate_rmse"] = round(
                    float(ate_rmse(traj[keep], gtp)), 4)
    if not args.vo_only:
        summary["loop_closures"] = engine.n_loop_closures
        # capped-work counters (fusion candidates / KF snapshots over
        # capacity) — surfaced so fixed-capacity compactions are never silent
        summary["counters"] = {k: v for k, v in engine.counters.items() if v}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
