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
same way; the T2I adapter's is in models/t2i_adapter.py. The loaders of
other model kinds wait for their consumers and raise.
"""

from __future__ import annotations

import json
import os

import torch

from ..pipeline import schedule as sched
from ..pipeline.tokenizer import load_tokenizer
from . import configs
from .configs import ModelSetConfig
from .modelset import ModelSet, convert_tree, map_specs, model_specs

_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}
_TOP = {"conv_in": "conv_in", "norm_out": "conv_norm_out",
        "conv_out": "conv_out"}
_EMBED = {"time_embed": "time_embedding", "add_embed": "add_embedding"}
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


def _not_ported(kind: str, item: str):
    raise NotImplementedError(
        f"loading {kind} weights is not ported to gyre_tpu_torch yet "
        f"(ROADMAP {item})")


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


def load_clip_vision_params(*_, **__):
    _not_ported("CLIP vision", "C6")


def load_clip_model_params(*_, **__):
    _not_ported("CLIP model", "C6")


def load_kunet_params(*_, **__):
    _not_ported("k-upscaler UNet", "D4")


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
    import dataclasses

    cfg = fallback
    uc = _read_json(os.path.join(path, "unet", "config.json"))
    if uc and ("KDownBlock2D" in (uc.get("down_block_types") or []) or
               uc.get("time_embedding_type") == "fourier"):
        load_kunet_params()
    if uc:
        cfg = dataclasses.replace(
            cfg, unet=configs.unet_config_from_diffusers(uc, fallback.unet),
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
        load_kunet_params()                      # k-upscaler layout
    unet_s, vae_s, text_s = model_specs(cfg)
    unet_p = load_tree(unet_s, unet_state, unet_keys, "unet", dtype, device)
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


def save_modelset(ms: ModelSet, path: str):
    """Export a ModelSet as a diffusers-layout safetensors directory (f32)
    with each part's config.json, the tokenizer and the scheduler config,
    as the JAX package writes it."""
    cfg = ms.config
    unet_s, vae_s, text_s = model_specs(cfg)
    parts = [("unet", "diffusion_pytorch_model.safetensors", ms.unet_params,
              unet_s, unet_keys,
              configs.unet_config_to_diffusers(cfg.unet, cfg.sample_size)),
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
