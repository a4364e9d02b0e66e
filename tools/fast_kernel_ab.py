"""A/B of the fused FAST-9 kernel against the plain XLA formulation, on a GPU.

Compiles ``run_vo_scan`` twice in one process — once as shipped (the
Pallas/Triton kernel on the GPU) and once with ``fast_score_map`` bound to
``fast_score_map_xla`` — on the 48-frame EuRoC 752x480 synthetic world,
times the two in turns (xla, triton, triton, xla) and reads one
``jax.profiler`` trace of each: device time of the FAST kernels, device busy
time and span of the scan.

Usage (repo root, one GPU):  python tools/fast_kernel_ab.py [-o OUT.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def hlo_attribution(hlo_text: str) -> dict:
    """Instruction name -> the ``op_name`` metadata of the instruction and of
    every instruction in the computation it calls (a fusion's body)."""
    comp_ops, inst_op, inst_calls = {}, {}, {}
    cur = None
    for line in hlo_text.splitlines():
        head = re.match(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if head and "=" not in line.split("{")[0]:
            cur = head.group(1)
            comp_ops.setdefault(cur, set())
            continue
        m = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        if not m:
            continue
        op = re.search(r'op_name="([^"]*)"', line)
        calls = re.search(r"calls=%?([\w.\-]+)", line)
        if op:
            inst_op[m.group(1)] = op.group(1)
            if cur is not None:
                comp_ops[cur].add(op.group(1))
        if calls:
            inst_calls[m.group(1)] = calls.group(1)
    return {name: ({inst_op[name]} if name in inst_op else set())
            | comp_ops.get(inst_calls.get(name, ""), set())
            for name in set(inst_op) | set(inst_calls)}


def kernel_to_hlo(kernel_name: str) -> str:
    """XLA:GPU names a fusion's kernel after the instruction with '.'
    replaced by '_' (``loop_fusion.12`` -> ``loop_fusion_12``)."""
    return re.sub(r"_(\d+)$", r".\1", kernel_name)


def reduce_trace(trace_dir: str, attrib: dict, scope: str,
                 kernel_tag: str) -> dict:
    """Device milliseconds of the kernels attributed to ``scope`` (through
    the HLO op_name metadata) or named with ``kernel_tag``, device busy
    time (union of kernel intervals) and the span of the window."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    pd = ProfileData.from_file(path)
    scoped_ns, n_scoped, intervals = 0.0, 0, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for e in line.events:
                ops = attrib.get(kernel_to_hlo(e.name), set())
                if kernel_tag in e.name or any(scope in o for o in ops):
                    scoped_ns += e.duration_ns
                    n_scoped += 1
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = intervals[-1][1] - intervals[0][0] if intervals else 0.0
    return {"fast_kernel_ms": scoped_ns / 1e6, "fast_kernel_launches":
            n_scoped, "busy_ms": busy / 1e6, "span_ms": span / 1e6,
            "kernel_launches": len(intervals)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from chip_smoke import render
    from gfplslam_tpu.config import CameraParams, Config
    from gfplslam_tpu.io import synthetic
    from gfplslam_tpu.models import vo as vo_mod
    from gfplslam_tpu.ops import fast as fast_ops
    from gfplslam_tpu.utils.device import device_record, require_gpu
    from gfplslam_tpu.utils.trajectory import ate_rmse

    require_gpu()
    shipped = fast_ops.fast_score_map

    def xla_scoped(img, th):
        with jax.named_scope("fast_score"):
            return fast_ops.fast_score_map_xla(img, th)

    variants = {"xla": xla_scoped, "triton": shipped}
    cam, n = CameraParams(), 48
    cfg = Config(camera=cam)
    world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90,
                                 seed=3, cam=cam, motion="forward")
    il, ir = render(world, n, noise=1.5)
    il, ir = jnp.asarray(il), jnp.asarray(ir)
    ts = jnp.asarray(world.timestamps.astype(np.float32))
    result = {"device": device_record(), "reps": args.reps, "frames": n}
    compiled, attrib = {}, {}
    for v, fn in variants.items():
        jax.clear_caches()
        fast_ops.fast_score_map = fn
        try:
            t0 = time.perf_counter()
            compiled[v] = vo_mod.run_vo_scan.lower(cfg, il, ir, ts).compile()
            compile_s = time.perf_counter() - t0
        finally:
            fast_ops.fast_score_map = shipped
        poses, _ = compiled[v](il, ir, ts)
        attrib[v] = hlo_attribution(compiled[v].as_text())
        result[v] = {"compile_s": compile_s,
                     "ate_m": float(ate_rmse(np.asarray(poses), world.poses)),
                     "scan_s": []}
    for v in ("xla", "triton", "triton", "xla"):
        for _ in range(args.reps):
            t0 = time.perf_counter()
            poses, _ = compiled[v](il, ir, ts)
            poses.block_until_ready()
            result[v]["scan_s"].append(time.perf_counter() - t0)
    for v in variants:
        result[v]["fps"] = (n - 1) / statistics.median(result[v]["scan_s"])
        print(f"[{v}] {json.dumps(result[v])}", flush=True)
    for v in variants:
        with tempfile.TemporaryDirectory() as d:
            jax.profiler.start_trace(d)
            poses, _ = compiled[v](il, ir, ts)
            poses.block_until_ready()
            jax.profiler.stop_trace()
            result[v]["trace"] = reduce_trace(d, attrib[v], "fast_score",
                                              "fast9_score")
        print(f"[{v}] trace {json.dumps(result[v]['trace'])}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
