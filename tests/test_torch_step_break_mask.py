"""The port's fused step against fastplong_tpu's with break (-b) and
N-mask (-N), alone, together and on the headline, on the CPU: the checks
of tests/test_torch_step.py over its BREAK_MASK_CONFIGS (a file of its
own so that the two halves run on two workers)."""

import pytest

from test_torch_step import (BREAK_MASK_CONFIGS, check_kernel_params,
                             check_step)


@pytest.mark.parametrize("name,extra", BREAK_MASK_CONFIGS,
                         ids=[c[0] for c in BREAK_MASK_CONFIGS])
def test_kernel_params_match_jax(name, extra):
    check_kernel_params(extra)


@pytest.mark.parametrize("with_stats", [True, False], ids=["stats",
                                                            "nostats"])
@pytest.mark.parametrize("name,extra", BREAK_MASK_CONFIGS,
                         ids=[c[0] for c in BREAK_MASK_CONFIGS])
def test_step_matches_jax(name, extra, with_stats):
    check_step(name, extra, with_stats)
