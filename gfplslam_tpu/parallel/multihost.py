"""Guarded multi-host initialization for distributed runs.

The reference is single-process (SURVEY.md section 2.4); this is the entry
point for spanning hosts: `jax.distributed.initialize` wires the processes
of a multi-host job into one SPMD world, after which `jax.devices()` is
global and the landmark-sharded BA (parallel/dist_ba.py) and batch
evaluation (parallel/batch.py) run unchanged over the full mesh.

Call :func:`ensure_multihost` once at process start (run_slam/batch_eval do
when ``--multihost`` is passed). It is a no-op when the env provides no
coordinator (single-host dev boxes, CI, the CPU test fixture) — so import
and call sites never need their own guards.
"""

from __future__ import annotations

import os

_INITIALIZED = False


def ensure_multihost(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed exactly once if a coordinator is known.

    Resolution order: explicit args, then the env vars
    JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS, NUM_PROCESSES and
    PROCESS_ID. All three must be known: nothing is auto-detected. Returns
    True when a multi-process world is active after the call.
    """
    global _INITIALIZED
    import jax

    if _INITIALIZED:
        return jax.process_count() > 1

    coordinator = coordinator or os.environ.get(
        "JAX_COORDINATOR_ADDRESS") or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", 0))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("PROCESS_ID", -1)))

    if coordinator and num_processes > 1 and process_id >= 0:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
        _INITIALIZED = True
    return _INITIALIZED and jax.process_count() > 1
