"""Stereo point+line SLAM engine in JAX (GF-PL-SLAM capabilities, built from scratch).

A JAX/XLA implementation of good-line-cutting stereo PL-SLAM:
ORB point + LSD/LBD line front-end as batched device kernels, robust pose-only
Gauss-Newton, information-maximizing line cutting, sliding-window local bundle
adjustment via Schur complement, bag-of-words loop closure with SE(3) pose-graph
optimization, and multi-host distributed BA over a `jax.sharding.Mesh`.

Reference capability map: see SURVEY.md at the repo root. Individual modules cite
the reference files (file:line) whose behavior they provide.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache: the engine's fused programs (front end,
# tracker, mapping pipeline) take tens of seconds to minutes to compile, and
# the cache makes every process after the first start in seconds. Where
# JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing is set here.
# Otherwise the cache lives at the fixed path <checkout>/.jax_cache: the
# directory is part of the cache key, so a path that moved would never hit.
# Opt out with GFPLSLAM_NO_COMPILE_CACHE=1.
if not _os.environ.get("GFPLSLAM_NO_COMPILE_CACHE"):
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

# Geometry and solver numerics need true fp32 products: at TF32 or bf16
# grade the 6x6 Hessian and SE(3) algebra is off by ~1e-2 (observed in a 3x3
# product). Image-plane kernels that tolerate bf16 opt in explicitly via
# preferred_element_type/precision.
_jax.config.update("jax_default_matmul_precision", "highest")

from gfplslam_tpu.config import Config, default_config  # noqa: F401
