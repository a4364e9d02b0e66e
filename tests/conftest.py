"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated here with
``--xla_force_host_platform_device_count=8``. Tests marked ``gpu`` need a
card and skip without one; run them on a GPU host with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# tests NEVER use the persistent compile cache: its writer
# (put_executable_and_time) has segfaulted full-suite runs when concurrent
# processes shared the cache dir — a CI gate must not depend on it
os.environ["GFPLSLAM_NO_COMPILE_CACHE"] = "1"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# a plugin may have imported jax before this conftest ran; the config update
# below re-pins the platforms as long as no backend has been initialized yet,
# and XLA_FLAGS is re-read at backend init so the 8-device CPU mesh forms.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
assert len(jax.devices("cpu")) == 8, (
    f"test harness needs the virtual 8-device CPU mesh, got "
    f"{jax.devices('cpu')} — a pre-imported jax backend defeated the pinning")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX finds none. Decided here, at
    run time, so every worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _bound_compiler_state():
    """Drop all live jitted executables between test modules.

    Full-suite runs in one process have segfaulted inside XLA:CPU's
    compiler after ~100 accumulated compiles (backend_compile_and_load,
    reproduced twice in this environment; also seen by round-3 review in
    put_executable_and_time); per-module cache clearing bounds the live
    compiler state so no module sees the others' accumulation. Costs only
    recompiles that module-scoped Configs would pay anyway."""
    yield
    jax.clear_caches()
