"""The port's checkpoint loader and export (gyre_tpu_torch.models.load, .ldm)
against the JAX package's on the SD_TEST preset, f32 on the CPU.

A checkpoint the JAX package exports loads in the port to exactly the
weights the bridge makes of the JAX package's own load of it (atol 0: both
read the same f32 bytes, and the layouts are permutations); the port's
export reloads exactly in the JAX package. The loader keeps the JAX
loader's tolerances (legacy VAE attention keys, CLIP keys without
``text_model.``, unused keys, fp16 files) and names a missing key. The
image test holds a txt2img image from the port-loaded engine to the JAX
pipeline on the JAX-loaded one within 2e-3, the bound of
test_torch_pipeline.py.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from gyre_tpu.models import configs as jconfigs
from gyre_tpu.models import ldm as jldm
from gyre_tpu.models import load as jload
from gyre_tpu.models import modelset as jms
from gyre_tpu.pipeline import modes as jmodes
from gyre_tpu.pipeline import unified as junified
from gyre_tpu.utils import rng as jrng
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.models import ldm as tldm
from gyre_tpu_torch.models import load as tload
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.pipeline import modes as tmodes
from gyre_tpu_torch.pipeline import unified as tunified

JCFG, TCFG = jconfigs.SD_TEST, tconfigs.SD_TEST
PARTS = ("unet_params", "vae_params", "text_params")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge(jax_ms, dtype=torch.float32):
    return tms.from_jax_params(
        _np(jax_ms.unet_params), _np(jax_ms.vae_params),
        [_np(t) for t in jax_ms.text_params],
        tconfigs.PRESETS["test"], dtype=dtype, device="cpu")


def _assert_same(a, b):
    """Two port ModelSets hold equal tensors, leaf by leaf."""
    for part in PARTS:
        la = jax.tree.leaves(getattr(a, part))
        lb = jax.tree.leaves(getattr(b, part))
        assert len(la) == len(lb), part
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y), part


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX ModelSet, the directory the JAX package exported it to)."""
    ms = jms.random_modelset(JCFG, seed=3, dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("jax_export"))
    jload.save_modelset(ms, path)
    return ms, path


def _port_load(path, fallback=TCFG, **kw):
    return tload.load_modelset(path, fallback, dtype=torch.float32,
                               device="cpu", **kw)


@pytest.mark.parametrize("fallback", ["test", "sd15"])
def test_load_equals_bridge_of_jax_load(exported, fallback):
    """Also with a wrong fallback preset: the config.json files win, and
    the derived config is the JAX package's."""
    _, path = exported
    port = _port_load(path, tconfigs.PRESETS[fallback])
    ref = jload.load_modelset(path, jconfigs.PRESETS[fallback])
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert dataclasses.asdict(port.config) == dataclasses.asdict(TCFG)
    _assert_same(port, _bridge(ref))
    assert port.schedule.prediction_type == ref.schedule.prediction_type
    assert np.array_equal(port.schedule.alphas_cumprod,
                          ref.schedule.alphas_cumprod)
    assert type(port.tokenizer).__name__ == type(ref.tokenizer).__name__


def test_port_export_reloads_exactly_in_jax(exported, tmp_path):
    jax_ms, _ = exported
    tload.save_modelset(_bridge(jax_ms), str(tmp_path))
    back = jload.load_modelset(str(tmp_path), JCFG)
    for part in PARTS:
        for x, y in zip(jax.tree.leaves(getattr(jax_ms, part)),
                        jax.tree.leaves(getattr(back, part))):
            assert np.array_equal(np.asarray(x), np.asarray(y)), part
    for sub in ("unet", "vae", "text_encoder", "scheduler"):
        assert os.listdir(tmp_path / sub)
    with open(tmp_path / "model_index.json") as fh:
        assert json.load(fh)["unet"] == ["diffusers", "UNet2DConditionModel"]


def test_export_keys_are_the_jax_exports(exported):
    """The port's key maps write the JAX package's keys and values."""
    jax_ms, _ = exported
    port = _bridge(jax_ms)
    specs = tms.model_specs(TCFG)
    for tree, jtree, spec, keys, jexport, cfg in (
            (port.unet_params, jax_ms.unet_params, specs[0], tload.unet_keys,
             jload.export_unet_state, JCFG.unet),
            (port.vae_params, jax_ms.vae_params, specs[1], tload.vae_keys,
             jload.export_vae_state, JCFG.vae),
            (port.text_params[0], jax_ms.text_params[0], specs[2][0],
             tload.clip_keys, jload.export_clip_state,
             JCFG.text_encoders[0])):
        ours = tload.export_tree(tree, spec, keys)
        ref = jexport(jtree, cfg)
        assert sorted(ours) == sorted(ref)
        for k, v in ours.items():
            assert np.array_equal(v.numpy(), ref[k]), k


def test_bf16_load_holds_the_random_engines_bits(tmp_path):
    """A bf16 engine exported (f32) and loaded again in bf16 holds the same
    bits, the f32 leaves of the fused convs included."""
    ms = tms.random_preset("test", seed=5, dtype=torch.bfloat16, device="cpu")
    tload.save_modelset(ms, str(tmp_path))
    back = tload.load_modelset(str(tmp_path), TCFG, dtype=torch.bfloat16,
                               device="cpu")
    _assert_same(ms, back)


def _rewrite(path, sub, fn, name=None):
    """Replace <path>/<sub>'s weights by fn(state), saved as ``name``."""
    d = os.path.join(path, sub)
    src = tload._find_weights(d)
    state = fn(load_file(src))
    os.remove(src)
    save_file(state, os.path.join(d, name or os.path.basename(src)))


def _legacy_vae(state):
    out = {}
    for k, v in state.items():
        if ".attentions.0." in k:
            for new, old in ((".to_q.", ".query."), (".to_k.", ".key."),
                             (".to_v.", ".value."),
                             (".to_out.0.", ".proj_attn."),
                             (".group_norm.", ".norm.")):
                k = k.replace(new, old)
            if k.endswith("weight") and v.ndim == 2:
                v = v[:, :, None, None].contiguous()   # 1x1 convs
        out[k] = v
    return out


TOLERANCES = {
    "legacy_vae_attention": ("vae", _legacy_vae, None),
    "clip_without_text_model": (
        "text_encoder", lambda s: {k.removeprefix("text_model."): v
                                   for k, v in s.items()}, None),
    "extra_position_ids": (
        "text_encoder",
        lambda s: dict(s, **{"text_model.embeddings.position_ids":
                             torch.arange(77)[None]}), None),
    "fp16_variant": (
        "unet", lambda s: {k: v.half() for k, v in s.items()},
        "diffusion_pytorch_model.fp16.safetensors"),
}


@pytest.mark.parametrize("case", sorted(TOLERANCES))
def test_loader_tolerances(exported, tmp_path, case):
    """Each variant loads in the port to the bridge of the JAX package's
    load of the same directory."""
    _, src = exported
    path = str(tmp_path / "ckpt")
    shutil.copytree(src, path)
    sub, fn, name = TOLERANCES[case]
    _rewrite(path, sub, fn, name)
    _assert_same(_port_load(path),
                 _bridge(jload.load_modelset(path, JCFG)))


def test_missing_key_raises_naming_it(exported, tmp_path):
    _, src = exported
    path = str(tmp_path / "ckpt")
    shutil.copytree(src, path)
    key = "mid_block.resnets.0.conv2.bias"
    _rewrite(path, "unet", lambda s: {k: v for k, v in s.items()
                                      if k != key})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        _port_load(path)


def _ldm_state(jax_ms):
    """An LDM single-file state dict of the JAX ModelSet (numpy), built as
    tests/test_ldm.py builds it."""
    cfg = JCFG
    state = jldm.diffusers_unet_to_ldm(
        jload.export_unet_state(jax_ms.unet_params, cfg.unet), cfg.unet)
    pairs = sorted(jldm._vae_rename_pairs(cfg.vae), key=lambda p: -len(p[1]))
    for key, val in jload.export_vae_state(jax_ms.vae_params,
                                           cfg.vae).items():
        for ldm_p, dif_p in pairs:
            if key.startswith(dif_p + "."):
                rest = key[len(dif_p) + 1:]
                inner = jldm._VAE_ATTN_INNER if "attn" in ldm_p else \
                    jldm._VAE_RES_INNER
                for li, di in inner:
                    if rest.startswith(di + "."):
                        rest = li + rest[len(di):]
                        break
                v = np.asarray(val)
                if "attn" in ldm_p and rest.split(".")[0] in \
                        ("q", "k", "v", "proj_out") and \
                        rest.endswith("weight") and v.ndim == 2:
                    v = v[:, :, None, None]
                state["first_stage_model." + ldm_p + "." + rest] = v
                break
    for k, v in jload.export_clip_state(jax_ms.text_params[0],
                                        cfg.text_encoders[0]).items():
        state["cond_stage_model.transformer." + k] = np.asarray(v)
    return state


def test_ldm_modelset_matches_jax(exported):
    jax_ms, _ = exported
    state = _ldm_state(jax_ms)
    # the copied rename tables give the JAX package's keys
    assert sorted(tldm.ldm_unet_to_diffusers(state, TCFG.unet)) == \
        sorted(jldm.ldm_unet_to_diffusers(state, JCFG.unet))
    assert sorted(tldm.ldm_vae_to_diffusers(state, TCFG.vae)) == \
        sorted(jldm.ldm_vae_to_diffusers(state, JCFG.vae))
    assert sorted(tldm.ldm_clip_to_transformers(state)) == \
        sorted(jldm.ldm_clip_to_transformers(state))
    port = tldm.load_ldm_modelset(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()}, TCFG,
        dtype=torch.float32, device="cpu")
    _assert_same(port, _bridge(jldm.load_ldm_modelset(state, JCFG)))
    _assert_same(port, _bridge(jax_ms))


def test_read_state_dict_ckpt(tmp_path):
    """A torch.save checkpoint, wrapped in state_dict, reads to the same
    arrays in both packages."""
    g = torch.Generator().manual_seed(0)
    state = {"a.weight": torch.randn(4, 3, generator=g),
             "a.bias": torch.randn(4, generator=g).half(),
             "n.running": torch.arange(5)}
    path = str(tmp_path / "model.ckpt")
    torch.save({"state_dict": state, "epoch": 3}, path)
    port = tload.read_state_dict(path)
    ref = jload.read_state_dict(path)
    assert sorted(port) == sorted(ref) == sorted(state)
    for k in state:
        assert np.array_equal(port[k].numpy(), ref[k])
        assert port[k].dtype == state[k].dtype


def _jax_noise(seeds, shape, sigma_max, device, natural=0):
    keys = jrng.keys_for_seeds(np.asarray(seeds, np.uint32))
    x = jmodes.txt2img_initial(keys, shape, sigma_max, natural=natural)
    return torch.from_numpy(np.array(x)).to(device)


def test_txt2img_from_loaded_engine_matches_jax(exported):
    """Images from the port-loaded engine (the JAX noise injected) against
    the JAX pipeline on the JAX-loaded engine."""
    _, path = exported
    request = dict(prompt="a (red:1.2) boat", negative_prompt="blurry",
                   height=64, width=64, steps=2, sampler="k_dpmpp_2m",
                   guidance_scale=7.5, seeds=[3])
    ref = np.asarray(junified.UnifiedPipeline(
        jload.load_modelset(path, JCFG),
        compute_dtype=jnp.float32)(**request))
    tpipe = tunified.UnifiedPipeline(_port_load(path),
                                     compute_dtype=torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodes, "txt2img_initial", _jax_noise)
        out = tpipe(**request).numpy()
    assert out.shape == ref.shape == (1, 64, 64, 3)
    assert np.abs(out - ref).max() <= 2e-3


@pytest.mark.parametrize("loader,item", [
    ("load_controlnet_params", "C4"), ("load_clip_vision_params", "C6"),
    ("load_clip_model_params", "C6"), ("load_kunet_params", "D4")])
def test_other_loaders_name_their_roadmap_item(loader, item):
    """A loader not ported yet raises naming its ROADMAP item; the
    ControlNet's (C4, ported since) is strict: an empty state dict names
    the first key it lacks."""
    if item == "C4":
        with pytest.raises(ValueError, match="no leaf conv_in.weight"):
            tload.load_controlnet_params({}, tconfigs.UNET_TEST,
                                         device="cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        getattr(tload, loader)({})
