"""Distributed-BA scaling benchmark over a device mesh.

Measures the landmark-sharded Schur-complement solver
(parallel/dist_ba.py) at 1, 2, 4, ... GPUs on a synthetic BA problem
(BASELINE config 5: keyframe/map-block partitioned distributed BA) and
reports per-iteration time + scaling efficiency, with the card named in the
JSON line. Needs an NVIDIA GPU: it exits non-zero without one.

Usage: python -m gfplslam_tpu.apps.bench_dist_ba --kfs 16 --points 4096
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def make_problem(n_kf: int, n_pt: int, n_ln: int, cam, seed: int = 0):
    import jax.numpy as jnp
    from gfplslam_tpu.models.ba import BAProblem

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n_pt), rng.uniform(-2, 2, n_pt),
                    rng.uniform(3, 14, n_pt)], 1).astype(np.float32)
    lsp = np.stack([rng.uniform(-4, 4, n_ln), rng.uniform(-2, 2, n_ln),
                    rng.uniform(3, 14, n_ln)], 1).astype(np.float32)
    lep = lsp + rng.normal(0, 0.6, (n_ln, 3)).astype(np.float32)
    lep[:, 2] = np.abs(lep[:, 2]) + 3
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (n_kf, 1, 1))
    for i in range(n_kf):
        poses[i][0, 3] = 0.08 * i
        poses[i][2, 3] = 0.02 * i

    def proj(t_wc, x):
        t_cw = np.linalg.inv(t_wc)
        pc = (t_cw[:3, :3] @ x.T).T + t_cw[:3, 3]
        return np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], 1)

    po_kf = np.repeat(np.arange(n_kf), n_pt).astype(np.int32)
    po_lm = np.tile(np.arange(n_pt), n_kf).astype(np.int32)
    po_uv = np.concatenate([proj(poses[k], pts) for k in range(n_kf)]
                           ).astype(np.float32)
    po_uv += rng.normal(0, 0.5, po_uv.shape).astype(np.float32)
    lo_kf = np.repeat(np.arange(n_kf), n_ln).astype(np.int32)
    lo_lm = np.tile(np.arange(n_ln), n_kf).astype(np.int32)
    lo_le = []
    for k in range(n_kf):
        s2 = proj(poses[k], lsp)
        e2 = proj(poses[k], lep)
        le = np.cross(np.concatenate([s2, np.ones((n_ln, 1))], 1),
                      np.concatenate([e2, np.ones((n_ln, 1))], 1))
        le /= np.linalg.norm(le[:, :2], axis=1, keepdims=True)
        lo_le.append(le.astype(np.float32))
    lo_le = np.concatenate(lo_le)

    return BAProblem(
        kf_pose=jnp.asarray(poses),
        kf_free=jnp.asarray([False] + [True] * (n_kf - 1)),
        kf_valid=jnp.ones(n_kf, bool),
        pt_pos=jnp.asarray(pts), pt_valid=jnp.ones(n_pt, bool),
        ln_sp=jnp.asarray(lsp), ln_ep=jnp.asarray(lep),
        ln_valid=jnp.ones(n_ln, bool),
        po_kf=jnp.asarray(po_kf), po_lm=jnp.asarray(po_lm),
        po_uv=jnp.asarray(po_uv), po_sigma2=jnp.ones(len(po_kf)),
        po_valid=jnp.ones(len(po_kf), bool),
        lo_kf=jnp.asarray(lo_kf), lo_lm=jnp.asarray(lo_lm),
        lo_le=jnp.asarray(lo_le), lo_sigma2=jnp.ones(len(lo_kf)),
        lo_valid=jnp.ones(len(lo_kf), bool))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=16)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--lines", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true",
                    help="also measure at 0.5x and 2x landmark counts "
                         "(scaling claims need more than one problem size)")
    args = ap.parse_args(argv)

    import statistics

    import jax
    from gfplslam_tpu.config import CameraParams
    from gfplslam_tpu.parallel import dist_ba
    from gfplslam_tpu.utils.device import device_record, require_gpu

    require_gpu(jax.devices())
    cam = CameraParams()
    n_dev = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16) if d <= n_dev]
    # landmark counts divisible by every mesh size (shard_problem pads
    # otherwise, which would bias the comparison)
    mults = [1.0] if not args.sweep else [0.5, 1.0, 2.0]
    problems = [(int(args.points * m) // 16 * 16,
                 int(args.lines * m) // 16 * 16) for m in mults]

    all_runs = {}
    for n_pt, n_ln in problems:
        prob = make_problem(args.kfs, n_pt, n_ln, cam, seed=args.seed)
        results = {}
        for nd in sizes:
            mesh = dist_ba.make_mesh(nd)
            sharded = dist_ba.shard_problem_by_landmark(prob, nd)
            res = dist_ba.solve_ba_sharded(cam, sharded, mesh,
                                           max_iters=args.iters)
            jax.block_until_ready(res.kf_pose)
            samples = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                res = dist_ba.solve_ba_sharded(cam, sharded, mesh,
                                               max_iters=args.iters)
                jax.block_until_ready(res.kf_pose)
                samples.append((time.perf_counter() - t0)
                               / args.iters * 1000)
            results[nd] = statistics.median(samples)
            print(f"[{n_pt}pt/{n_ln}ln] {nd} device(s): "
                  f"{results[nd]:.2f} ms/iter (median of {args.reps})",
                  flush=True)
        all_runs[(n_pt, n_ln)] = results

    # headline = the primary (1.0x) problem
    results = all_runs[problems[len(problems) // 2 if args.sweep else 0]]
    base = results[sizes[0]]
    out = {
        "metric": "dist_ba_ms_per_iter",
        "problem": dict(kfs=args.kfs, points=args.points, lines=args.lines,
                        obs=int(args.kfs * (args.points + args.lines))),
        "reps": args.reps, "seed": args.seed, "aggregation": "median",
        "device": device_record(),
        "ms_per_iter": {str(k): round(v, 3) for k, v in results.items()},
        "scaling_efficiency": {
            str(k): round(base / (v * k), 3) for k, v in results.items()},
    }
    if args.sweep:
        out["sweep"] = [
            {"points": p, "lines": l,
             "ms_per_iter": {str(k): round(v, 3) for k, v in r.items()},
             "scaling_efficiency": {
                 str(k): round(r[sizes[0]] / (v * k), 3)
                 for k, v in r.items()}}
            for (p, l), r in all_runs.items()]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
