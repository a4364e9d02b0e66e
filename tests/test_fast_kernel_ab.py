"""The trace-to-kernel-time reduction of tools/fast_kernel_ab.py, checked
off the card on a CPU-compiled program."""

import jax
import jax.numpy as jnp
import pytest

from gfplslam_tpu.ops import fast
from tools import fast_kernel_ab as ab


def test_kernel_name_maps_to_hlo_instruction():
    assert ab.kernel_to_hlo("input_concatenate_fusion_401") == \
        "input_concatenate_fusion.401"
    assert ab.kernel_to_hlo("fast9_score") == "fast9_score"


def test_hlo_attribution_follows_named_scope_into_fusions():
    def f(img, th):
        with jax.named_scope("fast_score"):
            s = fast.fast_score_map_xla(img, th)
        return fast.nms3(s)

    compiled = jax.jit(f).lower(jnp.zeros((24, 40)), 20.0).compile()
    attrib = ab.hlo_attribution(compiled.as_text())
    scoped = [n for n, ops in attrib.items()
              if any("fast_score" in o for o in ops)]
    assert scoped
    assert any(n not in scoped for n in attrib)


def test_refuses_to_run_without_gpu():
    with pytest.raises(SystemExit):
        ab.main([])
