"""LDM (.ckpt / single-file safetensors) checkpoint conversion.

Counterpart of gyre_tpu/models/ldm.py: the rename tables are copied as they
are (values pass through untouched, numpy arrays or torch tensors alike),
and ``load_ldm_modelset`` feeds the port's loader (models/load.py).

The reference converts LDM checkpoints to diffusers models with config
guessing (gyre/ckpt_utils.py:109-340). Here conversion is a pure key
renaming pass LDM -> diffusers naming (both directions, so it's testable
without real checkpoints), feeding the existing exact layout loaders in
models/load.py. Covers the SD1.x/2.x UNet (model.diffusion_model.*), VAE
(first_stage_model.*), and CLIP text tower (cond_stage_model.*).
"""

from __future__ import annotations

import torch

from .configs import ModelSetConfig, UNetConfig, VAEConfig

# ------------------------------------------------------------------- UNet


def _unet_rename_pairs(cfg: UNetConfig) -> list[tuple[str, str]]:
    """[(ldm_prefix, diffusers_prefix)] module-level renames."""
    pairs = [
        ("time_embed.0", "time_embedding.linear_1"),
        ("time_embed.2", "time_embedding.linear_2"),
        ("input_blocks.0.0", "conv_in"),
        ("out.0", "conv_norm_out"),
        ("out.2", "conv_out"),
        ("middle_block.0", "mid_block.resnets.0"),
        ("middle_block.1", "mid_block.attentions.0"),
        ("middle_block.2", "mid_block.resnets.1"),
    ]
    # down path
    idx = 1
    for lvl in range(cfg.levels):
        for j in range(cfg.layers_per_block):
            pairs.append((f"input_blocks.{idx}.0",
                          f"down_blocks.{lvl}.resnets.{j}"))
            if cfg.attn_levels[lvl]:
                pairs.append((f"input_blocks.{idx}.1",
                              f"down_blocks.{lvl}.attentions.{j}"))
            idx += 1
        if lvl < cfg.levels - 1:
            pairs.append((f"input_blocks.{idx}.0.op",
                          f"down_blocks.{lvl}.downsamplers.0.conv"))
            idx += 1
    # up path
    idx = 0
    for i in range(cfg.levels):
        lvl = cfg.levels - 1 - i
        for j in range(cfg.layers_per_block + 1):
            pairs.append((f"output_blocks.{idx}.0",
                          f"up_blocks.{i}.resnets.{j}"))
            slot = 1
            if cfg.attn_levels[lvl]:
                pairs.append((f"output_blocks.{idx}.{slot}",
                              f"up_blocks.{i}.attentions.{j}"))
                slot += 1
            if j == cfg.layers_per_block and i < cfg.levels - 1:
                pairs.append((f"output_blocks.{idx}.{slot}.conv",
                              f"up_blocks.{i}.upsamplers.0.conv"))
            idx += 1
    return pairs


_RES_INNER = [
    ("in_layers.0", "norm1"), ("in_layers.2", "conv1"),
    ("emb_layers.1", "time_emb_proj"),
    ("out_layers.0", "norm2"), ("out_layers.3", "conv2"),
    ("skip_connection", "conv_shortcut"),
]


def ldm_unet_to_diffusers(state: dict, cfg: UNetConfig) -> dict:
    """model.diffusion_model.* keys -> diffusers UNet keys."""
    pre = "model.diffusion_model."
    sub = {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}
    out = {}
    pairs = sorted(_unet_rename_pairs(cfg), key=lambda p: -len(p[0]))
    for key, val in sub.items():
        new = None
        for ldm_p, dif_p in pairs:
            if key.startswith(ldm_p + "."):
                rest = key[len(ldm_p) + 1:]
                if "resnets" in dif_p or dif_p.startswith("middle") or \
                        ".resnets." in dif_p:
                    for li, di in _RES_INNER:
                        if rest.startswith(li + "."):
                            rest = di + rest[len(li):]
                            break
                new = dif_p + "." + rest
                break
        if new is not None:
            out[new] = val
    return out


def diffusers_unet_to_ldm(state: dict, cfg: UNetConfig) -> dict:
    """Inverse renaming (used by tests and ckpt export)."""
    out = {}
    pairs = sorted(_unet_rename_pairs(cfg), key=lambda p: -len(p[1]))
    for key, val in state.items():
        new = None
        for ldm_p, dif_p in pairs:
            if key.startswith(dif_p + "."):
                rest = key[len(dif_p) + 1:]
                if ".resnets." in dif_p + ".":
                    for li, di in _RES_INNER:
                        if rest.startswith(di + "."):
                            rest = li + rest[len(di):]
                            break
                new = "model.diffusion_model." + ldm_p + "." + rest
                break
        if new is not None:
            out[new] = val
    return out


# -------------------------------------------------------------------- VAE


def _vae_rename_pairs(cfg: VAEConfig) -> list[tuple[str, str]]:
    n = len(cfg.block_out_channels)
    pairs = [
        ("encoder.conv_in", "encoder.conv_in"),
        ("encoder.norm_out", "encoder.conv_norm_out"),
        ("encoder.conv_out", "encoder.conv_out"),
        ("encoder.mid.block_1", "encoder.mid_block.resnets.0"),
        ("encoder.mid.attn_1", "encoder.mid_block.attentions.0"),
        ("encoder.mid.block_2", "encoder.mid_block.resnets.1"),
        ("decoder.conv_in", "decoder.conv_in"),
        ("decoder.norm_out", "decoder.conv_norm_out"),
        ("decoder.conv_out", "decoder.conv_out"),
        ("decoder.mid.block_1", "decoder.mid_block.resnets.0"),
        ("decoder.mid.attn_1", "decoder.mid_block.attentions.0"),
        ("decoder.mid.block_2", "decoder.mid_block.resnets.1"),
        ("quant_conv", "quant_conv"),
        ("post_quant_conv", "post_quant_conv"),
    ]
    for lvl in range(n):
        for j in range(cfg.layers_per_block):
            pairs.append((f"encoder.down.{lvl}.block.{j}",
                          f"encoder.down_blocks.{lvl}.resnets.{j}"))
        pairs.append((f"encoder.down.{lvl}.downsample.conv",
                      f"encoder.down_blocks.{lvl}.downsamplers.0.conv"))
    for i in range(n):
        ldm_lvl = n - 1 - i  # LDM decoder.up indices are reversed
        for j in range(cfg.layers_per_block + 1):
            pairs.append((f"decoder.up.{ldm_lvl}.block.{j}",
                          f"decoder.up_blocks.{i}.resnets.{j}"))
        pairs.append((f"decoder.up.{ldm_lvl}.upsample.conv",
                      f"decoder.up_blocks.{i}.upsamplers.0.conv"))
    return pairs


_VAE_RES_INNER = [("nin_shortcut", "conv_shortcut")]
_VAE_ATTN_INNER = [("norm", "group_norm"), ("q", "to_q"), ("k", "to_k"),
                   ("v", "to_v"), ("proj_out", "to_out.0")]


def ldm_vae_to_diffusers(state: dict, cfg: VAEConfig) -> dict:
    pre = "first_stage_model."
    sub = {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}
    out = {}
    pairs = sorted(_vae_rename_pairs(cfg), key=lambda p: -len(p[0]))
    for key, val in sub.items():
        for ldm_p, dif_p in pairs:
            if key == ldm_p + ".weight" or key == ldm_p + ".bias" or \
                    key.startswith(ldm_p + "."):
                rest = key[len(ldm_p) + 1:]
                inner = _VAE_ATTN_INNER if "attn" in ldm_p else \
                    _VAE_RES_INNER
                for li, di in inner:
                    if rest.startswith(li + "."):
                        rest = di + rest[len(li):]
                        break
                val2 = val
                # LDM VAE attention q/k/v/proj are 1x1 convs
                if "attn" in ldm_p and rest.split(".")[0] in (
                        "to_q", "to_k", "to_v") or \
                        ("attn" in ldm_p and rest.startswith("to_out")):
                    if rest.endswith("weight") and val2.ndim == 4:
                        val2 = val2[:, :, 0, 0]
                out[dif_p + "." + rest] = val2
                break
    return out


def ldm_clip_to_transformers(state: dict) -> dict:
    """cond_stage_model.* -> transformers CLIPTextModel naming."""
    out = {}
    for pre in ("cond_stage_model.transformer.",
                "conditioner.embedders.0.transformer."):
        for k, v in state.items():
            if k.startswith(pre):
                out[k[len(pre):]] = v
        if out:
            break
    return out


def load_ldm_modelset(state: dict, cfg: ModelSetConfig, dtype=torch.bfloat16,
                      device="cuda", engine_id: str = "ldm"):
    """Full LDM checkpoint dict -> ModelSet on ``device`` (reference ckpt
    engines, gyre/manager.py:1445-1509)."""
    from ..pipeline import schedule as sched
    from ..pipeline.tokenizer import FallbackTokenizer
    from . import load as load_mod
    from .modelset import ModelSet, model_specs

    device = torch.device(device)
    unet_s, vae_s, (text_s, *_) = model_specs(cfg)
    unet_params = load_mod.load_tree(
        unet_s, ldm_unet_to_diffusers(state, cfg.unet), load_mod.unet_keys,
        "unet", dtype, device)
    vae_params = load_mod.load_tree(
        vae_s, ldm_vae_to_diffusers(state, cfg.vae), load_mod.vae_keys,
        "vae", dtype, device)
    text_params = [load_mod.load_tree(
        text_s, ldm_clip_to_transformers(state), load_mod.clip_keys,
        "text_encoder", dtype, device)]
    schedule = sched.scaled_linear_schedule(
        prediction_type=cfg.prediction_type)
    return ModelSet(config=cfg, unet_params=unet_params,
                    vae_params=vae_params, text_params=text_params,
                    tokenizer=FallbackTokenizer(), schedule=schedule,
                    device=device, id=engine_id)
