"""Process-wide settings the package makes at import: the persistent
compile-cache directory and the default matmul precision."""

import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import gfplslam_tpu, jax; "
          "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("case", ["env_set", "env_unset", "opt_out"])
def test_compile_cache_policy(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and the package sets nothing; unset,
    the cache goes to the fixed <checkout>/.jax_cache; the opt-out leaves
    the cache off."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "GFPLSLAM_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    expected = os.path.join(REPO, ".jax_cache")
    if case == "env_set":
        expected = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = expected
    elif case == "opt_out":
        env["GFPLSLAM_NO_COMPILE_CACHE"] = "1"
        expected = "None"
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == expected


def test_matmul_precision_highest_after_import():
    import gfplslam_tpu  # noqa: F401
    assert jax.config.jax_default_matmul_precision == "highest"
