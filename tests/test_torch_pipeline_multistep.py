"""The port's pipeline with PLMS (its first-step corrector), dpm_fast (its
uniform-lambda ramp and 3-call segments) and dpm_adaptive (its solver
state carried across chunks) against the JAX package's UnifiedPipeline on
the SD_TEST preset, as tests/test_torch_pipeline_samplers.py does for the
samplers with per-step noise: the same weights, injected noise and
tolerance (2e-3 absolute on images in [0, 1]).

PLMS is held to the JAX package's single scan. Its chunked path skips the
corrector (tests/test_unified.py::test_chunked_dispatch_multistep_matches_single
fails for it); the port takes the corrector in the segment that holds
step 0, so its chunked run equals its one run in every bit.
"""

import pytest

from test_torch_pipeline_samplers import (REQUEST, check_chunked,  # noqa: F401
                                          check_single_scan, jax_noise,
                                          one_torch_thread, pipes)

SAMPLERS = ["plms", "dpm_fast", "dpm_adaptive"]


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_matches_jax_single_scan(pipes, jax_noise, sampler):  # noqa: F811
    check_single_scan(pipes, dict(REQUEST, sampler=sampler))


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_chunked_equals_unchunked(pipes, sampler):  # noqa: F811
    # dpm_adaptive's progress counts ceil(128 / 2) chunks of solver
    # iterations; it jumps to the end when the solver reaches sigma_min
    total = 128 if sampler == "dpm_adaptive" else REQUEST["steps"]
    check_chunked(pipes[1], dict(REQUEST, sampler=sampler), total)
