"""Checkpoint loading and export: diffusers-layout safetensors <-> ModelSet.

Counterpart of gyre_tpu/models/load.py, the Stable Diffusion subset: the
UNet (SD1.x, SD2's linear ``proj_in``/``proj_out``, SDXL's
``add_embedding``), the VAE (encoder and decoder) and the CLIP text towers
(``text_encoder``, and SDXL's ``text_encoder_2`` with its
``text_projection``). The port's
leaves are in torch's own layouts (linear (out, in), conv OIHW), so a
state-dict tensor goes in as it is; only the fused convs' HWIO weights
(``conv_hwio``) are permuted. The key maps are functions from a leaf's path
in the port's params tree to its state-dict key(s): loading walks the spec
tree through ``modelset.convert_tree`` (a missing or misshapen leaf raises
with its key; keys the model does not use are ignored) and export walks the
same tree, so each export is the exact inverse of its load.

Tolerances kept from the JAX loader: legacy VAE attention keys
(``query/key/value/proj_attn`` and ``norm``, with 1x1-conv weights), CLIP
keys with or without ``text_model.``, ``*.fp16.safetensors`` files.
Safetensors files are memory-mapped and each leaf goes to the engine's
device before it is cast, so no host copy of the model is made. The
ControlNet loader (and its exporter) walks the ControlNet's spec tree the
same way; the T2I adapter's is in models/t2i_adapter.py.

The CLIP vision loaders (the safety checker's and a CLIPModel's towers)
derive their configs from the shapes, as the JAX loaders do, and are
strict (``load_tree_strict``): a key they leave unread raises, except the
``position_ids`` buffers and CLIPModel's ``logit_scale``, which the
published files carry and no consumer reads. The JAX package's KeyMapper
ignores unread keys.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..pipeline import schedule as sched
from ..pipeline.tokenizer import load_tokenizer
from . import configs
from .configs import ModelSetConfig
# the sd-x2 latent upscaler's k-UNet: its own strict loader, the config
# from the shapes
from .kunet import load_kunet as load_kunet_params
from .modelset import ModelSet, convert_tree, map_specs, model_specs

_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}
_TOP = {"conv_in": "conv_in", "norm_out": "conv_norm_out",
        "conv_out": "conv_out"}
_EMBED = {"time_embed": "time_embedding", "add_embed": "add_embedding",
          "class_embed": "class_embedding"}
_MID = {"res1": "resnets.0", "res2": "resnets.1", "attn": "attentions.0"}
_RESNET = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2",
           "conv2": "conv2", "time_emb": "time_emb_proj",
           "shortcut": "conv_shortcut"}
_TBLOCK = {"ln1": "norm1", "ln2": "norm2", "ln3": "norm3", "attn1": "attn1",
           "attn2": "attn2", "ff1": "ff.net.0.proj", "ff2": "ff.net.2"}
_UNET_ATTN = {"q": "to_q", "k": "to_k", "v": "to_v", "out": "to_out.0"}
# VAE mid-block attention: (diffusers name, name in older checkpoints)
_VAE_ATTN = {"norm": ("group_norm", "norm"), "q": ("to_q", "query"),
             "k": ("to_k", "key"), "v": ("to_v", "value"),
             "out": ("to_out.0", "proj_attn")}
_CLIP_BLOCK = {"ln1": "layer_norm1", "ln2": "layer_norm2", "fc1": "mlp.fc1",
               "fc2": "mlp.fc2"}
_CLIP_ATTN = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj"}


# ---------------------------------------------------------------- key maps
# Each maps a leaf's path to its state-dict keys: the first is the one
# export writes, the others are accepted on load.


def _transformer(mod) -> str:
    if mod[0] != "blocks":                       # norm, proj_in, proj_out
        return mod[0]
    name = f"transformer_blocks.{mod[1]}.{_TBLOCK[mod[2]]}"
    if mod[2] in ("attn1", "attn2"):
        name += "." + _UNET_ATTN[mod[3]]
    return name


def unet_keys(path) -> tuple[str, ...]:
    *mod, leaf = path
    head = mod[0]
    if head in _EMBED:                           # lin1 -> linear_1
        name = f"{_EMBED[head]}.linear_{mod[1][-1]}"
    elif head == "mid":
        inner = _transformer(mod[2:]) if mod[1] == "attn" \
            else _RESNET[mod[2]]
        name = f"mid_block.{_MID[mod[1]]}.{inner}"
    elif head in ("down", "up"):
        blk = f"{head}_blocks.{mod[1]}"
        if mod[2] == "resnets":
            name = f"{blk}.resnets.{mod[3]}.{_RESNET[mod[4]]}"
        elif mod[2] == "attns":
            name = f"{blk}.attentions.{mod[3]}.{_transformer(mod[4:])}"
        else:                                    # downsample / upsample
            name = f"{blk}.{head}samplers.0.conv"
    else:
        name = _TOP[head]
    return (f"{name}.{_LEAF[leaf]}",)


def vae_keys(path) -> tuple[str, ...]:
    *mod, leaf = path
    leaf = _LEAF[leaf]
    if mod[0] in ("quant_conv", "post_quant_conv"):
        return (f"{mod[0]}.{leaf}",)
    part, sub = mod[0], mod[1]                   # encoder / decoder
    if sub == "mid" and mod[2] == "attn":
        pre = f"{part}.mid_block.attentions.0"
        return tuple(f"{pre}.{n}.{leaf}" for n in _VAE_ATTN[mod[3]])
    if sub == "mid":
        name = f"mid_block.{_MID[mod[2]]}.{_RESNET[mod[3]]}"
    elif sub in ("down", "up"):
        blk = f"{sub}_blocks.{mod[2]}"
        name = (f"{blk}.resnets.{mod[4]}.{_RESNET[mod[5]]}"
                if mod[3] == "resnets" else f"{blk}.{sub}samplers.0.conv")
    else:
        name = _TOP[sub]
    return (f"{part}.{name}.{leaf}",)


def clip_keys(path) -> tuple[str, ...]:
    if path[0] == "text_projection":
        return ("text_projection.weight",)
    if path[0] in ("token_embedding", "position_embedding"):
        name = f"embeddings.{path[0]}.weight"
    else:
        *mod, leaf = path
        if mod[0] == "final_ln":
            name = "final_layer_norm"
        else:                                    # blocks/<i>/...
            inner = (f"self_attn.{_CLIP_ATTN[mod[3]]}" if mod[2] == "attn"
                     else _CLIP_BLOCK[mod[2]])
            name = f"encoder.layers.{mod[1]}.{inner}"
        name += "." + _LEAF[leaf]
    return ("text_model." + name, name)


def load_tree(specs, state, keys, name: str, dtype, device):
    """A params tree from a state dict (torch layouts), on ``device``."""

    def fetch(path, s):
        cands = keys(path)
        key = next((k for k in cands if k in state), None)
        if key is None:
            raise KeyError(cands[0])
        t = torch.as_tensor(state[key])
        if s.kind == "conv_hwio":                # OIHW -> HWIO
            return t.permute(2, 3, 1, 0)
        if s.kind == "linear" and t.ndim == 4 and t.shape[2:] == (1, 1):
            return t[:, :, 0, 0]                 # old VAEs' 1x1 convs
        return t

    return convert_tree(specs, fetch, name, dtype, device)


def export_tree(params, specs, keys) -> dict[str, torch.Tensor]:
    """Inverse of load_tree: {key: f32 CPU tensor in torch layout}."""
    out = {}

    def put(path, s):
        t = params
        for k in path:
            t = t[k]
        t = t.detach().float()
        if s.kind == "conv_hwio":                # HWIO -> OIHW
            t = t.permute(3, 2, 0, 1)
        out[keys(path)[0]] = t.contiguous().cpu()

    map_specs(put, specs)
    return out


def load_tree_strict(specs, state, keys, name: str, dtype, device,
                     ignore=()):
    """load_tree that also raises on a key of ``state`` it leaves unread
    (a key containing one of the ``ignore`` tokens excepted)."""
    used = set()

    def recorded(path):
        cands = keys(path)
        hit = next((k for k in cands if k in state), None)   # load_tree's
        if hit is not None:
            used.add(hit)
        return cands

    out = load_tree(specs, state, recorded, name, dtype, device)
    left = sorted(k for k in state if k not in used and
                  not any(tok in k for tok in ignore))
    if left:
        raise KeyError(f"{name} loader left {len(left)} keys unread: "
                       + ", ".join(left[:8]))
    return out


def controlnet_keys(path) -> tuple[str, ...]:
    """A ControlNet leaf's diffusers ControlNetModel key: the UNet's for
    the twinned down path, mid block and time embedding."""
    *mod, leaf = path
    leaf = _LEAF[leaf]
    if mod[0] == "cond_embed":
        pre = "controlnet_cond_embedding"
        if mod[1] == "blocks":            # blocks.{2i} and blocks.{2i + 1}
            return (f"{pre}.blocks.{2 * mod[2] + (mod[3] == 'conv2')}."
                    f"{leaf}",)
        return (f"{pre}.{mod[1]}.{leaf}",)
    if mod[0] == "zero_convs":
        return (f"controlnet_down_blocks.{mod[1]}.{leaf}",)
    if mod[0] == "mid_zero":
        return (f"controlnet_mid_block.{leaf}",)
    return unet_keys(path)


def load_controlnet_params(state: dict, cfg: configs.UNetConfig,
                           dtype=torch.bfloat16, device="cuda") -> dict:
    """diffusers ControlNetModel state dict -> ControlNet params on
    ``device`` (models/controlnet.py), as strict as the UNet's loader."""
    from . import controlnet

    return load_tree(controlnet.param_specs(cfg), state, controlnet_keys,
                     "controlnet", dtype, device)


def export_controlnet_state(params: dict, cfg: configs.UNetConfig
                            ) -> dict[str, torch.Tensor]:
    """Inverse of load_controlnet_params."""
    from . import controlnet

    return export_tree(params, controlnet.param_specs(cfg), controlnet_keys)


# ------------------------------------------------------- CLIP vision, CLIP

# buffers and parameters the published CLIP files carry that no consumer
# reads
CLIP_IGNORED = ("position_ids", "logit_scale")
# head counts by width (not in the weights): ViT-B 768/12, ViT-L 1024/16,
# ViT-H 1280/16 (d = 80), ViT-g 1408/16 (d = 88), ViT-bigG 1664/16
VISION_HEADS = {768: 12, 1024: 16, 1280: 16, 1408: 16, 1664: 16}
# the tower's prefix in the layouts the vision exporter writes (either with
# visual_projection at the top level): diffusers' safety checker, and
# CLIPVisionModelWithProjection or a CLIPModel's vision half
VISION_LAYOUTS = {"safety": "vision_model.vision_model.",
                  "vision": "vision_model."}


def _vision_keys(pre: str, proj_key: str, pre_ln: str):
    def keys(path) -> tuple[str, ...]:
        if path[0] == "visual_projection":
            return (proj_key,)
        if path[0] == "patch_embed":
            return (f"{pre}embeddings.patch_embedding.weight",)
        if path[0] == "class_embed":
            return (f"{pre}embeddings.class_embedding",)
        if path[0] == "position_embedding":
            return (f"{pre}embeddings.position_embedding.weight",)
        *mod, leaf = path
        if mod[0] in ("pre_ln", "post_ln"):
            name = pre_ln if mod[0] == "pre_ln" else "post_layernorm"
            return (f"{pre}{name}.{_LEAF[leaf]}",)
        inner = (f"self_attn.{_CLIP_ATTN[mod[3]]}" if mod[2] == "attn"
                 else _CLIP_BLOCK[mod[2]])
        return (f"{pre}encoder.layers.{mod[1]}.{inner}.{_LEAF[leaf]}",)

    return keys


def _vision_layout(state: dict):
    """(tower prefix, visual_projection key or None, pre-LN name) of a
    state dict holding a CLIP vision tower."""
    cls_key = next((k for k in state
                    if k.endswith("embeddings.class_embedding")), None)
    if cls_key is None:
        raise KeyError("no CLIP vision tower in state dict")
    pre = cls_key[:-len("embeddings.class_embedding")]
    root = pre[:-len("vision_model.")] if pre.endswith("vision_model.") \
        else pre
    proj = next((k for k in ("visual_projection.weight",
                             pre + "visual_projection.weight",
                             root + "visual_projection.weight")
                 if k in state), None)
    # transformers spells the pre-LN "pre_layrnorm"
    pre_ln = "pre_layrnorm" if f"{pre}pre_layrnorm.weight" in state \
        else "pre_layernorm"
    return pre, proj, pre_ln


def _vision_config(state: dict, num_heads: int | None = None,
                           activation: str = "quick_gelu"):
    """The CLIPVisionConfig of a state dict's tower, from its shapes (the
    JAX loader's derivation)."""
    from .clip import CLIPVisionConfig

    pre, proj, _ = _vision_layout(state)
    hidden = int(state[f"{pre}embeddings.class_embedding"].shape[-1])
    patch = int(state[f"{pre}embeddings.patch_embedding.weight"].shape[-1])
    n_pos = int(state[f"{pre}embeddings.position_embedding.weight"
                      ].shape[0])
    n_layers = 0
    while f"{pre}encoder.layers.{n_layers}.layer_norm1.weight" in state:
        n_layers += 1
    return CLIPVisionConfig(
        image_size=int(round((n_pos - 1) ** 0.5)) * patch, patch_size=patch,
        hidden_size=hidden, num_layers=n_layers,
        num_heads=num_heads or VISION_HEADS.get(hidden) or
        max(hidden // 64, 1),
        intermediate_size=int(state[f"{pre}encoder.layers.0.mlp.fc1.weight"
                                    ].shape[0]),
        projection_dim=int(state[proj].shape[0]) if proj else hidden,
        activation=activation)


def load_clip_vision_params(state: dict, dtype=torch.bfloat16,
                            device="cuda", num_heads: int | None = None,
                            activation: str = "quick_gelu"):
    """A CLIP vision tower and its visual_projection from a torch state
    dict: diffusers' StableDiffusionSafetyChecker (``vision_model.
    vision_model.*``), CLIPVisionModel(WithProjection) (``vision_model.*``)
    or bare keys; without a projection, the identity (as the JAX loader).
    Returns (params on ``device``, CLIPVisionConfig). Strict: a key left
    unread raises, except CLIP_IGNORED's."""
    from .clip import vision_specs

    cfg = _vision_config(state, num_heads, activation)
    pre, proj, pre_ln = _vision_layout(state)
    if proj is None:
        proj = "visual_projection.weight"
        state = dict(state)
        state[proj] = torch.eye(cfg.hidden_size)
    return load_tree_strict(vision_specs(cfg), state,
                            _vision_keys(pre, proj, pre_ln), "clip vision",
                            dtype, device, CLIP_IGNORED), cfg


def export_clip_vision_state(params, cfg, layout: str = "vision"
                             ) -> dict[str, torch.Tensor]:
    """Inverse of load_clip_vision_params in one of VISION_LAYOUTS."""
    from .clip import vision_specs

    return export_tree(params, vision_specs(cfg), _vision_keys(
        VISION_LAYOUTS[layout], "visual_projection.weight", "pre_layrnorm"))


def _text_model_keys(path) -> tuple[str, ...]:
    return clip_keys(path)[:1]            # CLIPModel: text_model.* only


def load_clip_model_params(state: dict, dtype=torch.bfloat16,
                           device="cuda", activation: str | None = None,
                           text_heads: int | None = None,
                           vision_heads: int | None = None):
    """A transformers CLIPModel state dict (both towers and their
    joint-space projections) -> (text_params, text_cfg, vision_params,
    vision_cfg), both configs derived from the shapes as the JAX loader
    derives them; the activation and the head counts, which the weights
    do not carry, from the caller (the manager reads them from
    config.json), else quick_gelu and 64-wide text heads. Strict, as
    load_clip_vision_params."""
    from . import clip as clip_mod

    tpre = "text_model."
    tok_key = f"{tpre}embeddings.token_embedding.weight"
    if tok_key not in state:
        raise KeyError("no CLIP text tower (text_model.*) in state dict")
    vocab, hidden = (int(n) for n in state[tok_key].shape)
    n_layers = 0
    while f"{tpre}encoder.layers.{n_layers}.layer_norm1.weight" in state:
        n_layers += 1
    act = activation or "quick_gelu"
    text_cfg = configs.CLIPTextConfig(
        vocab_size=vocab, hidden_size=hidden, num_layers=n_layers,
        num_heads=text_heads or max(hidden // 64, 1),
        intermediate_size=int(state[f"{tpre}encoder.layers.0.mlp.fc1.weight"
                                    ].shape[0]),
        max_position_embeddings=int(
            state[f"{tpre}embeddings.position_embedding.weight"].shape[0]),
        projection_dim=int(state["text_projection.weight"].shape[0])
        if "text_projection.weight" in state else 0,
        activation=act, eos_token_id=vocab - 1)
    text_state = {k: v for k, v in state.items()
                  if k.startswith(tpre) or k == "text_projection.weight"}
    text_params = load_tree_strict(
        clip_mod.param_specs(text_cfg), text_state, _text_model_keys,
        "clip text", dtype, device, CLIP_IGNORED)
    vision_params, vision_cfg = load_clip_vision_params(
        {k: v for k, v in state.items() if k not in text_state}, dtype,
        device, vision_heads, act)
    return text_params, text_cfg, vision_params, vision_cfg


def export_clip_model_state(text_params, text_cfg, vision_params,
                            vision_cfg) -> dict[str, torch.Tensor]:
    """Inverse of load_clip_model_params, in CLIPModel's layout with its
    logit_scale (log(1 / 0.07), as CLIP initialises it)."""
    from . import clip as clip_mod

    out = export_tree(text_params, clip_mod.param_specs(text_cfg),
                      _text_model_keys)
    out.update(export_clip_vision_state(vision_params, vision_cfg, "vision"))
    out["logit_scale"] = torch.tensor(2.6592600345611572)
    return out


def clip_model_config(text_cfg, vision_cfg) -> dict:
    """A transformers CLIPModel config.json of the two towers: what the
    manager reads the activation and head counts from."""
    return {
        "architectures": ["CLIPModel"], "model_type": "clip",
        "projection_dim": vision_cfg.projection_dim,
        "text_config": {
            "hidden_size": text_cfg.hidden_size,
            "intermediate_size": text_cfg.intermediate_size,
            "num_attention_heads": text_cfg.num_heads,
            "num_hidden_layers": text_cfg.num_layers,
            "max_position_embeddings": text_cfg.max_position_embeddings,
            "vocab_size": text_cfg.vocab_size,
            "projection_dim": text_cfg.projection_dim,
            "hidden_act": text_cfg.activation},
        "vision_config": {
            "hidden_size": vision_cfg.hidden_size,
            "intermediate_size": vision_cfg.intermediate_size,
            "num_attention_heads": vision_cfg.num_heads,
            "num_hidden_layers": vision_cfg.num_layers,
            "image_size": vision_cfg.image_size,
            "patch_size": vision_cfg.patch_size,
            "projection_dim": vision_cfg.projection_dim,
            "hidden_act": vision_cfg.activation}}


# ------------------------------------------------------------------ files


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """The file's tensors on the CPU, memory-mapped: a tensor's bytes are
    read from the file when it is used."""
    from safetensors.torch import load_file

    return load_file(path)


def write_safetensors(path: str, state: dict):
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in state.items()}, path)


def _find_weights(dirpath: str, names=("diffusion_pytorch_model.safetensors",
                                       "model.safetensors")) -> str | None:
    for n in names:
        p = os.path.join(dirpath, n)
        if os.path.exists(p):
            return p
    # fp16 variants
    for n in names:
        p = os.path.join(dirpath, n.replace(".safetensors",
                                            ".fp16.safetensors"))
        if os.path.exists(p):
            return p
    return None


def read_state_dict(path: str) -> dict:
    """Checkpoint file or directory -> flat {key: tensor} on the CPU.
    Safetensors are memory-mapped; .ckpt/.pt/.bin/.pth go through
    ``torch.load(weights_only=True)``. Directories search the usual
    diffusers/BasicSR file names."""
    if os.path.isdir(path):
        found = _find_weights(path)
        if found is None:
            for n in sorted(os.listdir(path)):
                if n.endswith((".safetensors", ".pth", ".pt", ".ckpt",
                               ".bin")):
                    found = os.path.join(path, n)
                    break
        if found is None:
            raise FileNotFoundError(f"no checkpoint files under {path}")
        path = found
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    # unwrap the usual nesting ({'state_dict': ...}, {'params_ema': ...})
    for wrap in ("state_dict", "params_ema", "params"):
        if isinstance(state, dict) and wrap in state and \
                isinstance(state[wrap], dict) and len(state[wrap]) > 1:
            state = state[wrap]
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def _read_json(path: str) -> dict | None:
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh)
    return None


def _text_dir(i: int) -> str:
    return "text_encoder" if i == 0 else f"text_encoder_{i + 1}"


def derive_modelset_config(path: str,
                           fallback: ModelSetConfig) -> ModelSetConfig:
    """The architecture from the checkpoint's own config.json files; the
    preset fills what they cannot carry (clip_layer) and stands in where a
    checkpoint has none."""
    cfg = fallback
    uc = _read_json(os.path.join(path, "unet", "config.json"))
    if uc and ("KDownBlock2D" in (uc.get("down_block_types") or []) or
               uc.get("time_embedding_type") == "fourier"):
        # the k-upscaler UNet: load_modelset derives its dimensions from
        # the weights' shapes (models/kunet.py)
        cfg = dataclasses.replace(
            cfg, sample_size=int(uc.get("sample_size",
                                        fallback.sample_size)))
    elif uc:
        ucfg = configs.unet_config_from_diffusers(uc, fallback.unet)
        if uc.get("resnet_time_scale_shift") == "scale_shift":
            ucfg = dataclasses.replace(ucfg, time_scale_shift=True)
        cfg = dataclasses.replace(
            cfg, unet=ucfg,
            sample_size=int(uc.get("sample_size", fallback.sample_size)))
    vc = _read_json(os.path.join(path, "vae", "config.json"))
    if vc:
        cfg = dataclasses.replace(
            cfg, vae=configs.vae_config_from_diffusers(vc, fallback.vae))
    tes = []
    for i in range(4):
        tc = _read_json(os.path.join(path, _text_dir(i), "config.json"))
        if tc is None:
            break
        fb = fallback.text_encoders[min(i, len(fallback.text_encoders) - 1)]
        tes.append(configs.clip_config_from_diffusers(tc, fb))
    if tes:
        cfg = dataclasses.replace(cfg, text_encoders=tuple(tes))
    return cfg


def _schedule(path: str, prediction_type: str) -> sched.DiffusionSchedule:
    scfg = _read_json(os.path.join(path, "scheduler",
                                   "scheduler_config.json"))
    if scfg is None:
        return sched.scaled_linear_schedule(prediction_type=prediction_type)
    return sched.scaled_linear_schedule(
        num_timesteps=scfg.get("num_train_timesteps", 1000),
        beta_start=scfg.get("beta_start", 0.00085),
        beta_end=scfg.get("beta_end", 0.012),
        prediction_type=scfg.get("prediction_type", prediction_type))


def load_modelset(path: str, cfg: ModelSetConfig, dtype=torch.bfloat16,
                  device="cuda", engine_id: str = "loaded") -> ModelSet:
    """A diffusers-layout checkpoint directory (unet/ vae/ text_encoder/
    tokenizer/ scheduler/) -> ModelSet on ``device``. The directory's
    config.json files define the architecture; ``cfg`` fills the gaps."""
    device = torch.device(device)
    cfg = derive_modelset_config(path, cfg)
    unet_file = _find_weights(os.path.join(path, "unet"))
    vae_file = _find_weights(os.path.join(path, "vae"))
    if not unet_file or not vae_file:
        raise FileNotFoundError(f"no unet/vae safetensors under {path}")
    text_files = [_find_weights(os.path.join(path, _text_dir(i)))
                  for i in range(len(cfg.text_encoders))]
    for i, f in enumerate(text_files):
        if not f:
            raise FileNotFoundError(f"no {_text_dir(i)} safetensors under "
                                    f"{path}")
    unet_state = read_safetensors(unet_file)
    if "time_proj.weight" in unet_state and \
            not any(k.startswith("mid_block.") for k in unet_state):
        # the k-upscaler layout (sd-x2-latent-upscaler): its strict loader,
        # its config from the shapes
        unet_p, kcfg = load_kunet_params(unet_state, dtype, device)
        cfg = dataclasses.replace(cfg, unet=kcfg)
        _, vae_s, text_s = model_specs(cfg)
    else:
        unet_s, vae_s, text_s = model_specs(cfg)
        unet_p = load_tree(unet_s, unet_state, unet_keys, "unet", dtype,
                           device)
    vae_p = load_tree(vae_s, read_safetensors(vae_file), vae_keys, "vae",
                      dtype, device)
    text_p = [load_tree(s, read_safetensors(f), clip_keys, _text_dir(i),
                        dtype, device)
              for i, (s, f) in enumerate(zip(text_s, text_files))]
    return ModelSet(config=cfg, unet_params=unet_p, vae_params=vae_p,
                    text_params=text_p,
                    tokenizer=load_tokenizer(os.path.join(path, "tokenizer")),
                    schedule=_schedule(path, cfg.prediction_type),
                    device=device, id=engine_id)


def _kunet_config_to_diffusers(cfg, sample_size: int) -> dict:
    """A k-upscaler UNet's config.json, as the published sd-x2 latent
    upscaler's names it (its dimensions are read from the weights)."""
    down = ["KCrossAttnDownBlock2D" if a else "KDownBlock2D"
            for a in cfg.attn_levels]
    up = ["KCrossAttnUpBlock2D" if a else "KUpBlock2D"
          for a in reversed(cfg.attn_levels)]
    return {"_class_name": "UNet2DConditionModel",
            "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels, "sample_size": sample_size,
            "block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block,
            "down_block_types": down, "up_block_types": up,
            "mid_block_type": None, "time_embedding_type": "fourier",
            "cross_attention_dim": cfg.cross_attention_dim,
            "attention_head_dim": cfg.head_dim,
            "only_cross_attention": [not s for s in cfg.self_attn_levels]}


def save_modelset(ms: ModelSet, path: str):
    """Export a ModelSet as a diffusers-layout safetensors directory (f32)
    with each part's config.json, the tokenizer and the scheduler config,
    as the JAX package writes it."""
    from . import kunet

    cfg = ms.config
    unet_s, vae_s, text_s = model_specs(cfg)
    if isinstance(cfg.unet, kunet.KUNetConfig):
        unet_part = (unet_s, kunet.state_keys,
                     _kunet_config_to_diffusers(cfg.unet, cfg.sample_size))
    else:
        ucfg = configs.unet_config_to_diffusers(cfg.unet, cfg.sample_size)
        if cfg.unet.time_scale_shift:
            ucfg["resnet_time_scale_shift"] = "scale_shift"
        unet_part = (unet_s, unet_keys, ucfg)
    parts = [("unet", "diffusion_pytorch_model.safetensors", ms.unet_params,
              *unet_part),
             ("vae", "diffusion_pytorch_model.safetensors", ms.vae_params,
              vae_s, vae_keys, configs.vae_config_to_diffusers(cfg.vae))]
    index = {"_class_name": "StableDiffusionPipeline",
             "unet": ["diffusers", "UNet2DConditionModel"],
             "vae": ["diffusers", "AutoencoderKL"],
             "scheduler": ["diffusers", "DPMSolverMultistepScheduler"]}
    for i, (tp, s, te_cfg) in enumerate(zip(ms.text_params, text_s,
                                            cfg.text_encoders)):
        parts.append((_text_dir(i), "model.safetensors", tp, s, clip_keys,
                      configs.clip_config_to_diffusers(te_cfg)))
        index[_text_dir(i)] = ["transformers",
                               "CLIPTextModelWithProjection"
                               if te_cfg.projection_dim else "CLIPTextModel"]
    for sub, fname, params, specs, keys, sub_cfg in parts:
        # one part's f32 host copy at a time
        os.makedirs(os.path.join(path, sub), exist_ok=True)
        write_safetensors(os.path.join(path, sub, fname),
                          export_tree(params, specs, keys))
        with open(os.path.join(path, sub, "config.json"), "w") as fh:
            json.dump(sub_cfg, fh, indent=2)
    if hasattr(ms.tokenizer, "save"):
        ms.tokenizer.save(os.path.join(path, "tokenizer"))
        index["tokenizer"] = ["transformers", "CLIPTokenizer"]
    os.makedirs(os.path.join(path, "scheduler"), exist_ok=True)
    with open(os.path.join(path, "scheduler", "scheduler_config.json"),
              "w") as fh:
        json.dump({
            "num_train_timesteps": ms.schedule.num_train_timesteps,
            "beta_schedule": "scaled_linear",
            "beta_start": 0.00085, "beta_end": 0.012,
            "prediction_type": ms.schedule.prediction_type,
        }, fh, indent=2)
    with open(os.path.join(path, "model_index.json"), "w") as fh:
        json.dump(index, fh, indent=2)
