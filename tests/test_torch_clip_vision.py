"""The port's CLIP vision tower (gyre_tpu_torch.models.clip), its strict
loaders and exporters (models/load.py: the safety checker's and
CLIPVisionModelWithProjection's towers, a transformers CLIPModel), the
bridge, the manager's ``clip:`` model, the pipeline's CLIP text target and
a style hint through the pipeline, against the JAX package on the same
weights, f32 on the CPU.

Tolerances (ROADMAP): layers 1e-4, models 1e-3, images 2e-3 absolute.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import clip as jclip
from gyre_tpu.models import configs
from gyre_tpu.models import load as jload
from gyre_tpu.models import modelset as jms
from gyre_tpu.models import t2i_adapter as jt2i
from gyre_tpu.pipeline import modes as jmodes
from gyre_tpu.pipeline import unified as junified
from gyre_tpu.utils import rng as jrng
from gyre_tpu_torch.models import clip as tclip
from gyre_tpu_torch.models import load as tload
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.pipeline import modes as tmodes
from gyre_tpu_torch.pipeline import unified as tunified
from test_torch_modes import one_torch_thread  # noqa: F401

CFG = configs.SD_TEST
# two layers at ViT-L/14's widths: 224², patch 14, 1024 wide, 16 heads
VIT_L2 = dataclasses.replace(jclip.CLIP_VISION_L, num_layers=2)


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def clip_model_state(seed=0, hidden=64, layers=2, proj=64, vocab=49408,
                     img=32, patch=8, inter=128):
    """A transformers CLIPModel state dict (its key names, the
    ``pre_layrnorm`` spelling, ``logit_scale``), random, f32 numpy; the
    vocabulary of the engines' tokenizer, whose ids the text tower
    indexes."""
    r = np.random.default_rng(seed)
    s = {}

    def lin(pre, i, o, bias=True):
        s[f"{pre}.weight"] = (r.standard_normal((o, i)) * i ** -0.5
                              ).astype(np.float32)
        if bias:
            s[f"{pre}.bias"] = (r.standard_normal(o) * 0.02).astype(
                np.float32)

    def norm(pre, d):
        s[f"{pre}.weight"] = (1 + 0.1 * r.standard_normal(d)).astype(
            np.float32)
        s[f"{pre}.bias"] = (0.1 * r.standard_normal(d)).astype(np.float32)

    def tower(pre):
        for i in range(layers):
            lp = f"{pre}encoder.layers.{i}"
            norm(f"{lp}.layer_norm1", hidden)
            for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(f"{lp}.self_attn.{nm}", hidden, hidden)
            norm(f"{lp}.layer_norm2", hidden)
            lin(f"{lp}.mlp.fc1", hidden, inter)
            lin(f"{lp}.mlp.fc2", inter, hidden)

    s["text_model.embeddings.token_embedding.weight"] = \
        (r.standard_normal((vocab, hidden)) * 0.02).astype(np.float32)
    s["text_model.embeddings.position_embedding.weight"] = \
        (r.standard_normal((77, hidden)) * 0.01).astype(np.float32)
    tower("text_model.")
    norm("text_model.final_layer_norm", hidden)
    vp = "vision_model."
    s[f"{vp}embeddings.class_embedding"] = \
        (r.standard_normal(hidden) * 0.02).astype(np.float32)
    s[f"{vp}embeddings.patch_embedding.weight"] = \
        (r.standard_normal((hidden, 3, patch, patch)) * 0.02).astype(
            np.float32)
    s[f"{vp}embeddings.position_embedding.weight"] = \
        (r.standard_normal(((img // patch) ** 2 + 1, hidden)) * 0.01
         ).astype(np.float32)
    norm(f"{vp}pre_layrnorm", hidden)
    tower(vp)
    norm(f"{vp}post_layernorm", hidden)
    lin("visual_projection", hidden, proj, bias=False)
    lin("text_projection", hidden, proj, bias=False)
    s["logit_scale"] = np.asarray(4.6, np.float32)
    s["text_model.embeddings.position_ids"] = np.arange(77)[None]
    return s


def _torch_state(state):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}


@pytest.mark.parametrize("cfg", [jclip.CLIP_VISION_TEST, VIT_L2],
                         ids=["test", "vit_l_2_layers"])
def test_vision_apply_matches_jax(cfg):
    jp = jclip.vision_init(jax.random.PRNGKey(0), cfg)
    tp = tms.clip_vision_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    imgs = np.random.default_rng(0).random(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ref = jclip.vision_apply(jp, cfg, jclip.preprocess_image(
        jnp.asarray(imgs)))
    out = tclip.vision_apply(tp, cfg, tclip.preprocess_image(
        torch.from_numpy(imgs)))
    n = (cfg.image_size // cfg.patch_size) ** 2 + 1
    assert out["tokens"].shape == (2, n, cfg.hidden_size)
    for key in ("image_embeds", "pooled", "tokens"):
        assert out[key].dtype == torch.float32
        assert np.abs(_np(out[key]) - np.asarray(ref[key])).max() <= 1e-3
    assert np.allclose(np.linalg.norm(_np(out["image_embeds"]), axis=-1), 1,
                       atol=1e-5)


def test_preprocess_image_and_configs_match_jax():
    x = np.random.default_rng(1).random((2, 5, 4, 3)).astype(np.float32)
    assert np.abs(_np(tclip.preprocess_image(torch.from_numpy(x))) -
                  np.asarray(jclip.preprocess_image(jnp.asarray(x)))
                  ).max() <= 1e-6
    for name in ("CLIP_VISION_L", "CLIP_VISION_TEST"):
        assert dataclasses.asdict(getattr(tclip, name)) == \
            dataclasses.asdict(getattr(jclip, name))
    assert (tclip.IMAGE_MEAN, tclip.IMAGE_STD) == \
        (jclip.IMAGE_MEAN, jclip.IMAGE_STD)


@pytest.mark.parametrize("layout", ["safety", "vision"])
def test_vision_export_reads_back_in_both_loaders(layout):
    """The port's export in the safety checker's and
    CLIPVisionModelWithProjection's layouts, read by the port's strict
    loader and by the JAX one: the same config, the same embeddings."""
    cfg = jclip.CLIP_VISION_TEST
    tp = tclip.random_vision(cfg, 3, torch.float32, "cpu")
    state = tload.export_clip_vision_state(tp, cfg, layout)
    assert all(k.startswith(tload.VISION_LAYOUTS[layout]) or
               k == "visual_projection.weight" for k in state)
    back, tcfg = tload.load_clip_vision_params(state, torch.float32, "cpu")
    jp, jcfg = jload.load_clip_vision_params(
        {k: v.numpy() for k, v in state.items()}, num_heads=cfg.num_heads)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(
        dataclasses.replace(tcfg, num_heads=cfg.num_heads))
    imgs = np.random.default_rng(2).random((2, 32, 32, 3)).astype(
        np.float32)
    tcfg = dataclasses.replace(tcfg, num_heads=cfg.num_heads)
    a = tclip.vision_apply(back, tcfg, torch.from_numpy(imgs))
    b = tclip.vision_apply(tp, cfg, torch.from_numpy(imgs))
    c = jclip.vision_apply(jp, jcfg, jnp.asarray(imgs))
    assert torch.equal(a["image_embeds"], b["image_embeds"])
    assert np.abs(_np(a["image_embeds"]) - np.asarray(c["image_embeds"])
                  ).max() <= 1e-4


def test_clip_model_loader_matches_jax_and_reads_its_export():
    state = clip_model_state(1)
    tt, tcfg, tv, vcfg = tload.load_clip_model_params(
        _torch_state(state), torch.float32, "cpu", text_heads=4,
        vision_heads=4)
    jt, jtcfg, jv, jvcfg = jload.load_clip_model_params(
        state, text_heads=4, vision_heads=4)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jtcfg)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jvcfg)
    ids = np.asarray([[49406, 320, 1125, 49407] + [49407] * 73])
    tpooled = tclip.apply(tt, tcfg, torch.from_numpy(ids))["pooled"]
    jpooled = jclip.apply(jt, jtcfg, jnp.asarray(ids))["pooled"]
    assert np.abs(_np(tpooled) - np.asarray(jpooled)).max() <= 1e-4
    imgs = np.random.default_rng(3).random((1, 32, 32, 3)).astype(
        np.float32)
    assert np.abs(_np(tclip.vision_apply(tv, vcfg, torch.from_numpy(imgs))[
        "image_embeds"]) - np.asarray(jclip.vision_apply(
            jv, jvcfg, jnp.asarray(imgs))["image_embeds"])).max() <= 1e-4
    out = tload.export_clip_model_state(tt, tcfg, tv, vcfg)
    assert set(out) == set(state) - {"text_model.embeddings.position_ids"}
    assert all(torch.equal(out[k], torch.from_numpy(state[k]))
               for k in out if k != "logit_scale")
    jload.load_clip_model_params({k: v.numpy() for k, v in out.items()},
                                 text_heads=4, vision_heads=4)


@pytest.mark.parametrize("loader", ["load_clip_vision_params",
                                    "load_clip_model_params"])
def test_clip_loaders_are_strict(loader):
    """Both loaders raise on an empty state dict, on a key they leave
    unread, and on a misshapen leaf; the published buffers and CLIPModel's
    logit_scale are read past."""
    fn = getattr(tload, loader)
    with pytest.raises(KeyError):
        fn({}, torch.float32, "cpu")
    state = _torch_state(clip_model_state(2))
    if loader == "load_clip_vision_params":
        state = {k: v for k, v in state.items() if not k.startswith("text")}
    fn(state, torch.float32, "cpu")
    with pytest.raises(KeyError, match="unread"):
        fn(dict(state, **{"vision_model.extra.weight": torch.zeros(1)}),
           torch.float32, "cpu")
    bad = dict(state)
    bad["vision_model.post_layernorm.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        fn(bad, torch.float32, "cpu")


def test_bridge_is_strict():
    cfg = jclip.CLIP_VISION_TEST
    jp = jax.tree.map(np.asarray, jclip.vision_init(jax.random.PRNGKey(0),
                                                    cfg))
    jp["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        tms.clip_vision_from_jax(jp, cfg, device="cpu")
    del jp["extra"], jp["post_ln"]
    with pytest.raises(ValueError, match="post_ln"):
        tms.clip_vision_from_jax(jp, cfg, device="cpu")


def test_manager_clip_model_reads_config_json(tmp_path):
    """An engine's `clip:` reference resolves through the model registry
    chain to a CLIPModel directory; its config.json gives the activation
    (gelu here) and the head counts; the model is memoised across
    pipelines and reaches the pipeline's clip_vision."""
    from gyre_tpu_torch.manager.manager import EngineManager
    from gyre_tpu_torch.models.load import write_safetensors

    d = tmp_path / "tiny-clip"
    d.mkdir()
    write_safetensors(str(d / "model.safetensors"),
                      _torch_state(clip_model_state(3)))
    (d / "config.json").write_text(json.dumps({
        "text_config": {"hidden_act": "gelu", "num_attention_heads": 2},
        "vision_config": {"num_attention_heads": 8}}))
    specs = [{"model_id": "tiny-clip", "type": "clip", "model": str(d)},
             {"model_id": "clip-common", "type": "clip",
              "model": "@tiny-clip"},
             {"id": "a", "model": "preset/test", "clip": "@clip-common"},
             {"id": "b", "model": "preset/test", "clip_model": "@tiny-clip"}]
    m = EngineManager(specs, device="cpu", compute_dtype=torch.float32)
    try:
        vision, vcfg = m.pipeline("a").clip_vision()
        _, tcfg, _, _ = m.clip_model("@clip-common")
        assert (tcfg.activation, tcfg.num_heads) == ("gelu", 2)
        assert (vcfg.activation, vcfg.num_heads, vcfg.projection_dim) == \
            ("gelu", 8, 64)
        assert m.clip_model("@clip-common")[2] is vision
        assert m.pipeline("b").clip_source is not None
        assert m.pipeline("b").clip_vision()[1] == vcfg
    finally:
        m.dispatcher.stop()


# ---------------------------------------------------------- the pipeline


@pytest.fixture(scope="module")
def pipes():
    """JAX and port pipelines on SD_TEST's weights, each with a CLIP model
    loaded from the same state by its own loader."""
    jm = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    tree = (jax.tree.map(np.asarray, jm.unet_params),
            jax.tree.map(np.asarray, jm.vae_params),
            [jax.tree.map(np.asarray, t) for t in jm.text_params])
    jpipe = junified.UnifiedPipeline(jm, compute_dtype=jnp.float32)
    tpipe = tunified.UnifiedPipeline(
        tms.from_jax_params(*tree, CFG, device="cpu"),
        compute_dtype=torch.float32)
    state = clip_model_state(4)
    jclipm = jload.load_clip_model_params(state, text_heads=4,
                                          vision_heads=4)
    tclipm = tload.load_clip_model_params(_torch_state(state),
                                          torch.float32, "cpu",
                                          text_heads=4, vision_heads=4)
    jpipe.clip_source = lambda: jclipm
    tpipe.clip_source = lambda: tclipm
    return jpipe, tpipe


def test_clip_text_target_matches_jax(pipes):
    jpipe, tpipe = pipes
    ref = np.asarray(jpipe.clip_text_target("a red boat", 2))
    got = tpipe.clip_text_target("a red boat", 2)
    assert got.shape == (2, 64)
    assert np.abs(_np(got) - ref).max() <= 1e-4


def _jax_noise(seeds, shape, sigma_max, device, natural=0):
    keys = jrng.keys_for_seeds(np.asarray(seeds, np.uint32))
    x = jmodes.txt2img_initial(keys, shape, sigma_max, natural=natural)
    return torch.from_numpy(np.array(x)).to(device)


def test_style_hint_image_matches_jax(pipes, monkeypatch):
    """A style hint (a 2-layer style adapter of the tower's width and the
    UNet's context width, 8 tokens) through both pipelines: its tokens
    appended to the conditional context; the image within 2e-3, and
    different from the request without it."""
    jpipe, tpipe = pipes
    jstyle = jt2i.style_init(jax.random.PRNGKey(7), context_dim=64,
                             vision_dim=64, n_tokens=8, n_layers=2)
    tstyle = tms.style_from_jax(jax.tree.map(np.asarray, jstyle),
                                device="cpu")
    img = np.random.default_rng(8).random((1, 48, 40, 3)).astype(np.float32)
    req = dict(prompt="a red boat", negative_prompt="blurry", height=64,
               width=64, steps=2, sampler="k_euler", seeds=[3, 4],
               guidance_scale=7.5)
    ref = np.asarray(jpipe(**req, hints=[{"kind": "style", "image": img,
                                          "params": jstyle, "scale": 0.8}]))
    monkeypatch.setattr(tmodes, "txt2img_initial", _jax_noise)
    got = tpipe(**req, hints=[{"kind": "style", "image": img,
                               "params": tstyle, "scale": 0.8}])
    plain = tpipe(**req)
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert np.abs(_np(got) - ref).max() <= 2e-3
    assert np.abs(_np(got) - _np(plain)).max() > 1e-2


def test_style_checkpoint_routes_to_the_style_adapter(tmp_path):
    """A `t2i/style` hintset entry (config/engines/hintsets.yaml) over
    TencentARC's style checkpoint: the JAX hint manager builds every T2I
    entry as a full adapter, so the checkpoint does not load there and a
    style hint never reaches the style adapter; the port builds it as the
    style adapter (kind "style", the weights read back exactly). Without
    a checkpoint both build a random full adapter (kind "t2i")."""
    from gyre_tpu.manager import hints as jhints
    from gyre_tpu_torch.manager import hints as thints
    from gyre_tpu_torch.models import t2i_adapter as tt2i
    from gyre_tpu_torch.models.load import write_safetensors

    style = tt2i.random_style(0, torch.float32, "cpu", context_dim=64,
                              vision_dim=64, n_tokens=8, n_layers=1)
    path = tmp_path / "t2iadapter_style.safetensors"
    write_safetensors(str(path), tt2i.export_style_state(style))
    entry = {"hintset_id": "s",
             "t2i/style": {"aliases": "style", "model": str(path)},
             "t2i/sketch": {"aliases": "sketch"}}
    jm = jhints.HintsetManager([entry], CFG.unet,
                               compute_dtype=jnp.float32)
    tm = thints.HintsetManager([entry], CFG.unet,
                               compute_dtype=torch.float32, device="cpu")
    with pytest.raises(KeyError, match="conv_in.weight"):
        jm.for_type("style")
    got = tm.for_type("style")
    assert got["kind"] == "style"
    assert all(torch.equal(a, b) for a, b in zip(
        tms._leaves(got["params"]), tms._leaves(style)))
    assert jm.for_type("sketch")["kind"] == tm.for_type("sketch")["kind"] \
        == "t2i"
