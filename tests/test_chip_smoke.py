"""chip_smoke.py off the card: its device check, its references and
comparison helpers, and its phase functions at small sizes on the CPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from __graft_entry__ import small_config
from gfplslam_tpu.config import CameraParams, CapacityParams, Config, OrbParams
from gfplslam_tpu.parallel import dist_ba

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = Config(
    cap=CapacityParams(n_pt=128, n_ln=64), orb=OrbParams(nlevels=1),
    camera=CameraParams(width=188, height=120, fx=108.8, fy=108.8,
                        cx=91.8, cy=63.0, baseline=0.11))


def test_require_gpu_refuses_cpu_platform():
    with pytest.raises(SystemExit) as e:
        cs.require_gpu(jax.devices())
    assert "cpu" in str(e.value.code)
    with pytest.raises(SystemExit):
        cs.require_gpu([])


def test_script_exits_nonzero_without_gpu():
    """The script as the user runs it: no GPU, non-zero exit, no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_hamming_reference_bit_definition(rng):
    a = rng.integers(0, 2 ** 32, size=(5, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=(7, 8), dtype=np.uint32)
    ref = cs.hamming_reference(a, b, rows=2)
    for i in range(5):
        for j in range(7):
            want = sum(bin(int(x) ^ int(y)).count("1")
                       for x, y in zip(a[i], b[j]))
            assert ref[i, j] == want


def test_fast_reference_corner_and_flat():
    img = np.zeros((32, 32), np.float32)
    img[12:24, 12:24] = 200.0
    s = cs.fast_score_reference(img, 20.0)
    assert s[12, 12] > 0 and s.max() == pytest.approx(180.0)
    assert cs.fast_score_reference(np.full((16, 16), 9.0, np.float32),
                                   5.0).max() == 0


def test_kernel_phase_small_shapes():
    out = cs.kernel_phase([(40, 70), (2, 3, 30, 50)], [(64, 64), (100, 60)])
    assert len(out) == 4
    assert out["hamming(64, 64)"] == out["hamming(100, 60)"] == 0
    assert out["fast(2, 3, 30, 50)"] == {"vs_numpy": 0, "vs_xla": 0,
                                        "vs_xla_blurred": 0}


def test_match_fraction_and_pose_diff():
    a = np.array([[0.0, 0.0], [10.0, 10.0], [5.0, 5.0]])
    b = np.array([[0.01, 0.0], [10.0, 10.2]])
    assert cs.match_fraction(a, b, 0.05) == pytest.approx(1 / 3)
    assert cs.match_fraction(a[:0], b[:0], 0.05) == 1.0
    assert cs.match_fraction(a, b[:0], 0.05) == 0.0
    p = np.tile(np.eye(4), (2, 1, 1))
    q = p.copy()
    q[1, 0, 3] = 0.002
    c, s = np.cos(0.01), np.sin(0.01)
    q[1, :2, :2] = [[c, -s], [s, c]]
    dt, dr = cs.pose_diff(p, q)
    assert dt == pytest.approx(0.002)
    assert dr == pytest.approx(0.01, rel=1e-3)


def test_frontend_compare_two_cpu_devices():
    """The card-vs-CPU comparison, here between two CPU devices at the
    small front-end configuration: identical programs agree exactly."""
    d = jax.devices("cpu")
    res = cs.frontend_compare(small_config(), d[0], d[1])
    assert res["kp_match_frac"] == 1.0
    assert res["n_kp"][0] == res["n_kp"][1] > 0


def test_vo_phase_tiny():
    res = cs.vo_phase(TINY, 4, seed=3, n_points=300, n_lines=40)
    assert res["frames"] == 4
    assert np.isfinite(res["ate_m"]) and res["ate_m"] < 0.5
    assert res["compile_s"] > 0 and res["run_s"] > 0


def test_four_ba_compare_virtual_mesh():
    res = cs.four_ba_compare(dist_ba.make_mesh(4), 4, 64, 16,
                             jax.devices()[0], max_iters=5)
    assert res["iters_sharded"] == res["iters_single"]
    assert res["kf_pos_diff_m"] <= cs.FOUR_BA_POS_TOL


@pytest.mark.gpu
def test_kernel_phase_main_path_widths(gpu_device):
    """FAST at the EuRoC level widths and Hamming at map-association width,
    compiled for the card, against the NumPy references."""
    h1, w1 = cs.EUROC_LEVEL1
    out = cs.kernel_phase([(480, 752), (2, 3, h1, w1)], [(1024, 16384)])
    assert out["hamming(1024, 16384)"] == 0
    assert set(out["fast(480, 752)"].values()) == {0}


def test_four_vo_compare_virtual_mesh():
    """Batch VO sharded one sequence per device against each sequence's
    own scan, at the small front-end configuration."""
    res = cs.four_vo_compare(small_config(),
                             dist_ba.make_mesh(4, axis="seq"), 4, 3,
                             jax.devices()[0])
    assert len(res["per_seq"]) == 4
    assert res["max_pose_diff"] <= cs.FOUR_VO_POSE_TOL


def test_interactive_phase_small():
    """apps.run_slam.main in process, per-frame SLAMSystem.process, at
    reduced capacities."""
    res = cs.interactive_phase(3, small=True)
    assert res["frames"] == 3 and not res["lost"]
    assert np.isfinite(res["ate_rmse"])
