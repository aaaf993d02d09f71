"""The port's SD2 path against the JAX package on a tiny SD2 topology: the
SD_TEST preset with linear ``proj_in``/``proj_out``, v-prediction,
``clip_layer=-2`` and a GELU text tower (the JAX package has no SD2 test
preset, so both sides build it with ``dataclasses.replace``), the JAX
random weights carried over by ``from_jax_params`` and the JAX package's
draws put in at the port's seam (``jax_draws``).

Tolerances: the UNet 1e-3 of max |JAX| (f32, sums in another order
through a deep net, as tests/test_torch_models.py); the v-prediction
denoiser 1e-5 (f32 arithmetic against host-float coefficients); images
2e-3 absolute in [0, 1], as for every other pipeline test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import configs
from gyre_tpu.models import unet as junet
from gyre_tpu.pipeline import denoiser as jden
from gyre_tpu.pipeline import schedule as jsched
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import unet as tunet
from gyre_tpu_torch.pipeline import denoiser as tden
from gyre_tpu_torch.pipeline import schedule as tsched
from test_torch_modes import (REQUEST, check_images, init_image,  # noqa: F401
                              jax_draws, make_pipes, one_torch_thread)


def sd2_test(c):
    """The SD2 topology on the SD_TEST widths, in a configs module's
    dataclasses (the JAX package's or the port's)."""
    return dataclasses.replace(
        c.SD_TEST,
        unet=dataclasses.replace(c.UNET_TEST, linear_projection=True),
        text_encoders=(dataclasses.replace(c.CLIP_TEST, activation="gelu"),),
        clip_layer=-2, prediction_type="v_prediction")


CFG = sd2_test(configs)


@pytest.fixture(scope="module")
def pipes():
    return make_pipes(CFG)


def test_unet_linear_projection_matches_jax(pipes):
    jpipe, tpipe = pipes
    assert tpipe.ms.unet_params["down"][0]["attns"][0]["proj_in"][
        "w"].dim() == 2                          # linear, (out, in)
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.5, 700.0], np.float32)
    ctx = r.standard_normal((2, 77, 64)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda *a: junet.apply(a[0], CFG.unet,
                                                    *a[1:]))(
        jpipe.ms.unet_params, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx)))
    with torch.inference_mode():
        out = tunet.apply(tpipe.ms.unet_params, CFG.unet,
                          torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(ctx)).numpy()
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
def test_denoiser_matches_jax(pred):
    """x0 from an analytic model output at sigmas across the ramp, under
    the schedule's prediction type and under the override."""
    x = np.random.default_rng(1).standard_normal((2, 4, 4, 4)).astype(
        np.float32)

    def model(x, t):
        return x * 0.3 + t[:, None, None, None] * 1e-3

    jsch = jsched.scaled_linear_schedule(prediction_type="v_prediction")
    tsch = tsched.scaled_linear_schedule(prediction_type="v_prediction")
    override = None if pred == "v_prediction" else pred
    jdn = jden.make_denoiser(model, jsch, prediction_type=override)
    tdn = tden.make_denoiser(model, tsch, prediction_type=override)
    for sigma in (14.6, 3.0, 0.7, 0.03):
        ref = np.asarray(jdn(jnp.asarray(x), sigma))
        out = tdn(torch.from_numpy(x), sigma).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_contexts_penultimate_gelu_match_jax(pipes):
    """SD2's context: the GELU tower's penultimate block through the final
    layer norm, the config's layer when the request names none."""
    jpipe, tpipe = pipes
    texts = ["a (red:1.2) boat at [dusk]", ""]
    ref = np.asarray(jpipe.encode_prompt_list(texts, 1))
    with torch.inference_mode():
        out = tpipe.encode_prompt_list(texts, 1, clip_layer=0).numpy()
        last = tpipe.encode_prompt_list(texts, 1, clip_layer=-1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert np.abs(last - out).max() > 1e-2


def test_txt2img_matches_jax(pipes, jax_draws):  # noqa: F811
    check_images(pipes, dict(REQUEST, steps=3))


def test_img2img_matches_jax(pipes, jax_draws):  # noqa: F811
    check_images(pipes, dict(REQUEST, steps=3, init_image=init_image(),
                             strength=0.7))


@pytest.fixture(scope="module")
def graft_pipes():
    """An epsilon SD_TEST root with the v-prediction SD2 model grafted on
    top."""
    return make_pipes(configs.SD_TEST, graft_cfg=CFG)


def test_graft_onto_v_prediction_matches_jax(graft_pipes,
                                             jax_draws):  # noqa: F811
    _, tpipe = graft_pipes
    assert tpipe.graft_ms.schedule.prediction_type == "v_prediction"
    assert tpipe.ms.schedule.prediction_type == "epsilon"
    check_images(graft_pipes, dict(REQUEST, steps=3))


@pytest.mark.parametrize("preset", ["sd21", "sd21-base"])
def test_sd21_presets_build_specs(preset):
    """The full-width presets' spec trees build (OpenCLIP-H, linear
    projections, v-prediction at 768² for sd21), and the UNet has SD2's
    published parameter count (865,910,724)."""
    cfg = tconfigs.PRESETS[preset]
    unet, _, (tower,) = tms.model_specs(cfg)
    n = sum(int(np.prod(s.shape)) for _, s in _leaves(unet))
    assert n == 865_910_724
    assert tower["blocks"][0]["fc1"]["w"].shape == (4096, 1024)
    assert cfg.clip_layer == -2 and cfg.text_encoders[0].activation == "gelu"
    assert (cfg.prediction_type, cfg.sample_size) == (
        ("v_prediction", 96) if preset == "sd21" else ("epsilon", 64))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_lora_on_linear_projections_matches_jax(pipes):
    """A kohya LoRA for SD2's linear proj_in/proj_out (2-D deltas) and a
    1x1-conv one (4-D, an SD1-style export) fold into the linear leaves
    as the JAX package folds them."""
    from gyre_tpu.pipeline import lora as jlora
    from gyre_tpu_torch.pipeline import lora as tlora

    jpipe, tpipe = pipes
    r = np.random.default_rng(2)
    state = {}
    for name, conv in (("down_blocks_0_attentions_0_proj_in", False),
                       ("up_blocks_3_attentions_2_proj_out", True)):
        up = r.standard_normal((32, 4)).astype(np.float32) * 0.1
        down = r.standard_normal((4, 32)).astype(np.float32) * 0.1
        if conv:
            up, down = up[:, :, None, None], down[:, :, None, None]
        key = f"lora_unet_{name}"
        state[f"{key}.lora_up.weight"] = up
        state[f"{key}.lora_down.weight"] = down
        state[f"{key}.alpha"] = np.float32(2.0)
    ju, _, jn = jlora.apply_lora(jpipe.ms.unet_params,
                                 jpipe.ms.text_params, state, 0.8)
    tu, _, tn = tlora.apply_lora(tpipe.ms.unet_params,
                                 tpipe.ms.text_params, state, 0.8,
                                 config=tpipe.ms.config)
    assert jn == tn == 2
    for path in (("down", 0, "attns", 0, "proj_in"),
                 ("up", 3, "attns", 2, "proj_out")):
        j, t = ju, tu
        for k in path:
            j, t = j[k], t[k]
        np.testing.assert_allclose(t["w"].numpy(), np.asarray(j["w"]).T,
                                   atol=1e-6, rtol=0)
