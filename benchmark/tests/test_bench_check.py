"""The check that decides ``correct``, driven through the rest of a run on
the CPU at the port's test preset (the card's look skipped): the served
PNGs of a sound run agree with the float32 reference; a run whose timed
path is broken underneath reads ``correct`` false; the fp8 control fails
the limits."""

import pytest
import torch

from benchmark import harness, traffic, weights
from benchmark.reference import sd
from benchmark.tests import cells

STEPS = 4


def _run(monkeypatch=None, fault=None):
    cell = cells.test_cell(steps=STEPS)
    if fault is not None:
        fault(monkeypatch)
    run = harness.measure(cell, cells.SEED, 2.0, False, 0.0, device="cpu")
    out = harness.check(run, device="cpu")
    return run, out


def test_sound_run_agrees_with_the_reference():
    run, out = _run()
    assert run.check["correct"], out
    assert out["image_mean_gap"]["value"] < 0.05
    assert out["failed_requests"]["value"] == 0
    assert out["weights_regenerated_equal"]["value"] == 1


def _first_step_unchanged(mp):
    from gyre_tpu_torch.pipeline import samplers

    real = samplers.SAMPLERS["k_dpmpp_2m"]

    def broken(denoise, x, sigmas, noise_fn, p, start=0, steps=None,
               carry=None, return_carry=False):
        n = len(sigmas) - 1
        steps = n - start if steps is None else steps
        # the first step of each segment returns the latents unchanged
        return real(denoise, x, sigmas, noise_fn, p, start=start + 1,
                    steps=steps - 1, carry=carry, return_carry=return_carry)

    mp.setitem(samplers.SAMPLERS, "k_dpmpp_2m", broken)


def _half_the_batch(mp):
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline

    real = UnifiedPipeline._to_uint8

    def broken(self, images):
        out = real(self, images)
        half = out.shape[0] // 2
        if half:                           # the second half answered with
            out[half:2 * half] = out[:half]   # the first half's rows
        return out

    mp.setattr(UnifiedPipeline, "_to_uint8", broken)


def _answer_altered(mp):
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline

    real = UnifiedPipeline._to_uint8

    def broken(self, images):
        out = real(self, images)
        out[:, 0, 0, 0] ^= 0x40            # one value of every image
        return out

    mp.setattr(UnifiedPipeline, "_to_uint8", broken)


@pytest.mark.parametrize("fault", [_first_step_unchanged, _half_the_batch,
                                   _answer_altered])
def test_broken_path_is_not_correct(monkeypatch, fault):
    run, out = _run(monkeypatch, fault)
    assert not run.check["correct"], out


def test_fp8_control_fails_the_limits():
    """The reference in fp8 e4m3 (the next precision below the served
    bf16) in the program's place, at the test preset on three seeds,
    judged by the run's own comparison at the test cell's limits."""
    cell = cells.test_cell(steps=STEPS)
    limits = cell["workload"]["check"]["limits"]
    for seed in (11, 12, 13):
        reqs = [c[0] for c in traffic.client_requests(cell["mix"], seed)]
        state = weights.make(cell["config"], seed, "cpu", torch.bfloat16)
        want = sd.Reference(cell["config"], state).generate(reqs, "cpu")
        got = sd.Reference(cell["config"], state,
                           quant=sd.fp8_quant).generate(reqs, "cpu")
        gaps = [harness.image_gaps(g, w) for g, w in zip(got, want)]
        out, correct = harness.judge([m for m, _ in gaps],
                                     [x for _, x in gaps], limits)
        assert not correct, out
        assert out["image_mean_gap"]["value"] > limits["image_mean_gap"]
        assert out["image_max_gap"]["value"] > limits["image_max_gap"]
