"""The port's SDXL path (two towers, pooled text and time ids, the
refiner's 5 ids) against the JAX package on its SDXL_TEST and
SDXL_REFINER_TEST presets, the JAX random weights carried over by
``from_jax_params`` and the JAX package's draws put in at the port's seam
(``jax_draws``).

Tolerances: the UNet and the ControlNet 1e-3 of max |JAX| (f32, sums in
another order through deep nets); the dual-tower contexts and the pooled
text 1e-4 absolute; images 2e-3 absolute in [0, 1], as for every other
pipeline test; a chunked run equals its one run in every bit; a loader
round trip holds every bit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import configs
from gyre_tpu.models import controlnet as jcn
from gyre_tpu.models import load as jload
from gyre_tpu.models import unet as junet
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.models import controlnet as tcn
from gyre_tpu_torch.models import load as tload
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import unet as tunet
from test_torch_modes import (REQUEST, check_images, init_image,  # noqa: F401
                              jax_draws, make_pipes, one_torch_thread)
from test_torch_pipeline_samplers import check_chunked
from test_torch_sd2 import _leaves

XL, REFINER = configs.SDXL_TEST, configs.SDXL_REFINER_TEST
STEPS = 3


@pytest.fixture(scope="module")
def pipes():
    return make_pipes(XL)


@pytest.fixture(scope="module")
def refiner_pipes():
    return make_pipes(REFINER)


def _added(cfg, r, batch=2, size=64):
    ids = [size, size, 0, 0, size, size][:cfg.addition_time_ids]
    if cfg.addition_time_ids == 5:
        ids = [size, size, 0, 0, 6.0]
    return {"text_embeds": r.standard_normal(
        (batch, cfg.addition_embed_dim)).astype(np.float32),
        "time_ids": np.array([ids] * batch, np.float32)}


@pytest.mark.parametrize("which", ["base", "refiner"])
def test_unet_with_added_cond_matches_jax(pipes, refiner_pipes, which):
    jpipe, tpipe = pipes if which == "base" else refiner_pipes
    cfg = jpipe.ms.config.unet
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.5, 700.0], np.float32)
    ctx = r.standard_normal((2, 77, cfg.cross_attention_dim)).astype(
        np.float32)
    added = _added(cfg, r)
    ref = np.asarray(jax.jit(lambda p, x, t, c, a: junet.apply(
        p, cfg, x, t, c, added_cond=a))(
            jpipe.ms.unet_params, jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(ctx), {k: jnp.asarray(v) for k, v in added.items()}))
    with torch.inference_mode():
        out = tunet.apply(tpipe.ms.unet_params, cfg, torch.from_numpy(x),
                          torch.from_numpy(t), torch.from_numpy(ctx),
                          added_cond={k: torch.from_numpy(v)
                                      for k, v in added.items()})
        plain = tunet.apply(tpipe.ms.unet_params, cfg, torch.from_numpy(x),
                            torch.from_numpy(t), torch.from_numpy(ctx))
    assert np.abs(out.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    # the text_time embedding reaches the output
    assert float((out - plain).abs().max()) > 1e-3 * np.abs(ref).max()


def test_dual_tower_contexts_and_pooled_match_jax(pipes):
    """Each tower's context, one chunk padding for both, concatenated along
    the feature axis (64 + 32 = 96); the pooled text is the last tower's
    projected EOS row."""
    jpipe, tpipe = pipes
    texts = ["a (red:1.2) boat at [dusk]", "", "a " * 90 + "cat"]
    ref = np.asarray(jpipe.encode_prompt_list(texts, 2))
    ref_pooled = np.asarray(jpipe.encode_pooled_batch(texts))
    with torch.inference_mode():
        out = tpipe.encode_prompt_list(texts, 2).numpy()
        pooled = tpipe.encode_pooled_batch(texts).numpy()
    assert out.shape == ref.shape == (3, 152, 96)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert pooled.shape == ref_pooled.shape == (3, 32)
    np.testing.assert_allclose(pooled, ref_pooled, atol=1e-4, rtol=0)


def test_added_cond_rows(pipes):
    """Coalesced rows keep their own pooled text, in the contexts' order;
    the base's 6 time ids are the request's size in pixels."""
    _, tpipe = pipes
    added_u, added_g = tpipe._added_cond(["a cat", "a dog"], ["", "blurry"],
                                         2, True, 64, 96)
    alone = tpipe.encode_pooled_batch(["a dog", "blurry"])
    torch.testing.assert_close(added_g["text_embeds"][1], alone[0])
    torch.testing.assert_close(added_u["text_embeds"][1], alone[1])
    assert added_g["time_ids"].tolist() == [[64, 96, 0, 0, 64, 96]] * 2
    assert added_u["time_ids"].tolist() == added_g["time_ids"].tolist()


def test_txt2img_matches_jax(pipes, jax_draws):  # noqa: F811
    check_images(pipes, dict(REQUEST, steps=STEPS))


def test_coalesced_prompts_match_jax(pipes, jax_draws):  # noqa: F811
    """A batch of two prompts with their own negatives and guidance
    scales, as the dispatcher merges them."""
    check_images(pipes, dict(REQUEST, steps=STEPS,
                             prompt=["a (red:1.2) boat", "a cat"],
                             negative_prompt=["blurry", ""],
                             guidance_scale=[7.5, 5.0]))


def test_refiner_img2img_matches_jax(refiner_pipes,
                                     jax_draws):  # noqa: F811
    """The refiner's stage: img2img with 5 time ids (6.0 guided, 2.5
    unguided aesthetic scores)."""
    check_images(refiner_pipes, dict(REQUEST, steps=STEPS,
                                     init_image=init_image(), strength=0.66))


def test_chunked_equals_unchunked(pipes):
    check_chunked(pipes[1], dict(REQUEST, steps=5), 5)


def test_hint_on_sdxl_matches_jax(pipes):
    """The JAX package's ControlNet on an SDXL UNet (no add_embed: it runs
    without the pooled text and time ids) against the port's, its zero
    convs made non-zero so that every residual is compared."""
    cfg = XL.unet
    r = np.random.default_rng(3)
    params = jax.tree.map(np.asarray, jcn.init(jax.random.PRNGKey(1), cfg))
    for zc in params["zero_convs"] + [params["mid_zero"],
                                      params["cond_embed"]["conv_out"]]:
        zc["w"] = r.standard_normal(zc["w"].shape).astype(np.float32) * 0.1
    tparams = tms.controlnet_from_jax(params, cfg, device="cpu")
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.5, 700.0], np.float32)
    ctx = r.standard_normal((2, 77, 96)).astype(np.float32)
    hint = r.random((2, 64, 64, 3)).astype(np.float32)
    emb = jcn.embed_condition(params, jnp.asarray(hint))
    jd, jm = jcn.apply(params, cfg, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(ctx), emb, conditioning_scale=0.8)
    with torch.inference_mode():
        temb = tcn.embed_condition(tparams, torch.from_numpy(hint))
        td, tm = tcn.apply(tparams, cfg, torch.from_numpy(x),
                           torch.from_numpy(t), torch.from_numpy(ctx), temb,
                           conditioning_scale=0.8)
    assert len(td) == len(jd) == 6          # conv_in, 2 + 1, 2
    for a, b in zip(td + [tm], list(jd) + [jm]):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-3 * np.abs(b).max()


def test_lora_te2_deltas_go_to_tower_zero_as_in_jax(pipes):
    """A kohya SDXL LoRA's ``lora_te2_`` deltas (OpenCLIP-bigG's) are sent
    to tower 0 by the JAX package's resolver, where they do not fit
    CLIP-L's leaves and are dropped: neither package changes tower 1 (the
    fault is recorded in ROADMAP queue 3). Its ``lora_te1_`` deltas fold
    into tower 0 in both."""
    from gyre_tpu.pipeline import lora as jlora
    from gyre_tpu_torch.pipeline import lora as tlora

    jpipe, tpipe = pipes
    r = np.random.default_rng(4)
    state = {}
    for te, width in (("lora_te1", 64), ("lora_te2", 32)):
        key = f"{te}_text_model_encoder_layers_0_self_attn_q_proj"
        state[f"{key}.lora_up.weight"] = r.standard_normal(
            (width, 4)).astype(np.float32)
        state[f"{key}.lora_down.weight"] = r.standard_normal(
            (4, width)).astype(np.float32)
    _, jte, jn = jlora.apply_lora(jpipe.ms.unet_params,
                                  jpipe.ms.text_params, state, 1.0)
    _, tte, tn = tlora.apply_lora(tpipe.ms.unet_params,
                                  tpipe.ms.text_params, state, 1.0,
                                  config=tpipe.ms.config)
    assert jn == tn == 1
    assert tte[1] is tpipe.ms.text_params[1]
    for j, t in zip(jte, tte):
        np.testing.assert_allclose(
            t["blocks"][0]["attn"]["q"]["w"].numpy(),
            np.asarray(j["blocks"][0]["attn"]["q"]["w"]).T, atol=1e-6)


def test_export_loads_back_and_in_jax(pipes, tmp_path):
    """An SDXL export (two towers, text_encoder_2 with its projection, the
    add_embedding, linear projections) loads back in every bit through
    its own config.json files, with a wrong fallback preset; the JAX
    loader reads it to the JAX package's own weights."""
    jpipe, tpipe = pipes
    tload.save_modelset(tpipe.ms, str(tmp_path))
    assert os.listdir(tmp_path / "text_encoder_2")
    back = tload.load_modelset(str(tmp_path), tconfigs.SDXL_TEST,
                               dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(back.config) == \
        dataclasses.asdict(tpipe.ms.config)
    for part in ("unet_params", "vae_params", "text_params"):
        la, lb = jax.tree.leaves(getattr(tpipe.ms, part)), \
            jax.tree.leaves(getattr(back, part))
        assert len(la) == len(lb)
        assert all(torch.equal(a, b) for a, b in zip(la, lb)), part
    derived = tload.derive_modelset_config(str(tmp_path), tconfigs.SD15)
    assert dataclasses.asdict(derived.unet) == \
        dataclasses.asdict(XL.unet)                   # the 32 + 6 x 16 split
    # no config.json carries the CLIP layer: under the sd15 fallback a bare
    # path takes -1 in both packages, where SDXL wants -2 (ROADMAP queue 3)
    jderived = jload.derive_modelset_config(str(tmp_path), configs.SD15)
    assert derived.clip_layer == jderived.clip_layer == -1
    jback = jload.load_modelset(str(tmp_path), XL)
    for part in ("unet_params", "vae_params", "text_params"):
        for a, b in zip(jax.tree.leaves(getattr(jpipe.ms, part)),
                        jax.tree.leaves(getattr(jback, part))):
            assert np.array_equal(np.asarray(a), np.asarray(b)), part
    with open(tmp_path / "unet" / "config.json") as fh:
        unet_cfg = json.load(fh)
    assert unet_cfg["addition_embed_type"] == "text_time"
    assert unet_cfg["use_linear_projection"] is True


@pytest.mark.parametrize("preset,unet_params,embed_dim,ids", [
    ("sdxl", 2_567_463_684, 1280, 6), ("sdxl-refiner", 2_259_526_660, 1280,
                                       5)])
def test_sdxl_presets_build_specs(preset, unet_params, embed_dim, ids):
    """The full-width presets' spec trees build, at the published UNet
    parameter counts, with bigG's 1280-wide text projection."""
    cfg = tconfigs.PRESETS[preset]
    unet, _, towers = tms.model_specs(cfg)
    assert sum(int(np.prod(s.shape)) for _, s in _leaves(unet)) == \
        unet_params
    assert unet["add_embed"]["lin1"]["w"].shape == (
        cfg.unet.time_embed_dim, embed_dim + 256 * ids)
    assert towers[-1]["text_projection"]["w"].shape == (1280, 1280)
    assert cfg.vae.scaling_factor == 0.13025 and cfg.sample_size == 128


@pytest.mark.parametrize("field", ["class_embed", "time_scale_shift"])
def test_upscaler_conditioning_raises_naming_d4(field):
    """The upscalers' UNet conditioning builds (the test keeps its name from
    before ROADMAP D4b, when it raised): the port's spec tree at UNET_TEST
    with the field takes the JAX init's tree through the strict bridge (a
    missing, extra or misshapen leaf raises) with the new leaves in it, and
    a ControlNet of that config takes the JAX ControlNet's tree (its
    resnets keep additive time conditioning in both packages).
    tests/test_torch_diffusion_upscaler.py holds the outputs to JAX."""
    jcfg = dataclasses.replace(configs.UNET_TEST, **{field: True})
    tcfg = dataclasses.replace(tconfigs.UNET_TEST, **{field: True})
    tree = tms._from_jax(
        tunet.param_specs(tcfg),
        jax.tree.map(np.asarray, junet.init(jax.random.PRNGKey(0), jcfg)),
        "unet", torch.float32, torch.device("cpu"))
    res = tree["down"][0]["resnets"][0]
    if field == "class_embed":
        assert tree["class_embed"]["lin1"]["w"].shape == (
            jcfg.time_embed_dim, jcfg.block_out_channels[0])
        assert res["time_emb"]["w"].shape[0] == res["conv1"]["w"].shape[-1]
    else:
        assert "class_embed" not in tree
        assert res["time_emb"]["w"].shape[0] == \
            2 * res["conv1"]["w"].shape[-1]
    cn = tms.controlnet_from_jax(
        jax.tree.map(np.asarray, jcn.init(jax.random.PRNGKey(1), jcfg)),
        tcfg, device="cpu")
    cres = cn["down"][0]["resnets"][0]
    assert cres["time_emb"]["w"].shape[0] == cres["conv1"]["w"].shape[-1]
