"""ModelSet: one engine's weights, configs, tokenizer and schedule.

Counterpart of gyre_tpu/models/modelset.py. Two ways to fill one:

  * ``random_modelset``: random weights at a config's full width from a
    seeded ``torch.Generator`` on the target device: linear and conv
    weights uniform in +-1/sqrt(fan_in) (gyre_tpu/models/layers.py's
    inits), norm scales 1, biases 0, CLIP embeddings N(0, 0.02^2) and
    N(0, 0.01^2).
  * ``from_jax_params``: the JAX package's params trees (numpy arrays),
    converted to the port's layouts leaf by leaf: linear (in, out) ->
    (out, in), conv HWIO -> OIHW, the fused convs' HWIO kept. Any missing,
    misshapen or unconsumed leaf raises, except the subtrees of parts not
    ported yet (NOT_PORTED).

Loading real safetensors checkpoints is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from gyre_tpu.models import configs
from gyre_tpu.pipeline.tokenizer import FallbackTokenizer

from ..pipeline import schedule as sched
from . import clip as clip_mod
from . import layers as L
from . import unet as unet_mod
from . import vae as vae_mod

# JAX params subtrees of parts the port does not run yet (VAE encoder:
# img2img / inpaint), skipped by the bridge
NOT_PORTED = {"vae": ("encoder", "quant_conv")}


@dataclass
class ModelSet:
    config: configs.ModelSetConfig
    unet_params: Any
    vae_params: Any
    text_params: list
    tokenizer: Any
    schedule: sched.DiffusionSchedule
    device: torch.device
    id: str = "unnamed"

    def param_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for tree in
                   [self.unet_params, self.vae_params, *self.text_params]
                   for t in _leaves(tree))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map_specs(fn, tree, path=()):
    """Rebuild a spec tree with fn(path, spec) at every leaf."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _specs(cfg: configs.ModelSetConfig):
    return (unet_mod.param_specs(cfg.unet), vae_mod.param_specs(cfg.vae),
            [clip_mod.param_specs(te) for te in cfg.text_encoders])


def _random_tree(specs, gen, dtype, device):
    def make(_, s: L.Spec):
        if s.kind == "bias":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.kind == "norm_scale":
            return torch.ones(s.shape, dtype=dtype, device=device)
        if s.kind == "normal":
            t = torch.randn(s.shape, generator=gen, device=device) * s.std
            return t.to(dtype)
        bound = s.fan_in() ** -0.5
        t = torch.rand(s.shape, generator=gen, device=device)
        return ((t * 2.0 - 1.0) * bound).to(dtype)

    return _map_specs(make, specs)


def random_modelset(cfg: configs.ModelSetConfig, seed: int = 0,
                    dtype=torch.bfloat16, device="cpu",
                    engine_id: str = "random") -> ModelSet:
    """Architecture-faithful random weights, made on ``device`` from
    ``seed`` (one generator, leaves drawn in tree order)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    unet_s, vae_s, text_s = _specs(cfg)
    with torch.inference_mode():
        unet_p = _random_tree(unet_s, gen, dtype, device)
        vae_p = _random_tree(vae_s, gen, dtype, device)
        text_p = [_random_tree(s, gen, dtype, device) for s in text_s]
    return ModelSet(config=cfg, unet_params=unet_p, vae_params=vae_p,
                    text_params=text_p, tokenizer=FallbackTokenizer(),
                    schedule=sched.scaled_linear_schedule(
                        prediction_type=cfg.prediction_type),
                    device=device, id=engine_id)


def random_preset(preset: str, seed: int = 0, dtype=torch.bfloat16,
                  device="cpu", engine_id: str | None = None) -> ModelSet:
    """random_modelset of a gyre_tpu.models.configs preset by name
    ("sd15", "test", ...)."""
    cfg = configs.PRESETS.get(preset)
    if cfg is None:
        raise ValueError(f"unknown preset {preset!r}")
    return random_modelset(cfg, seed=seed, dtype=dtype, device=device,
                           engine_id=engine_id or preset)


# ------------------------------------------------------------------ bridge


def _jax_leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_leaf_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_leaf_paths(v, path + (i,))
    else:
        yield path


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _convert(specs, jax_tree, name: str, dtype, device, skip=()):
    consumed = set()

    def take(path, s: L.Spec):
        try:
            a = np.asarray(_get(jax_tree, path), dtype=np.float32)
        except (KeyError, IndexError, TypeError):
            raise ValueError(f"{name}: JAX params have no leaf "
                             f"{'/'.join(map(str, path))}") from None
        if s.kind == "linear":
            a = a.T
        elif s.kind == "conv":
            a = a.transpose(3, 2, 0, 1)
        if tuple(a.shape) != s.shape:
            raise ValueError(f"{name}: leaf {'/'.join(map(str, path))} has "
                             f"shape {a.shape} after conversion, the port "
                             f"expects {s.shape}")
        consumed.add(path)
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)

    out = _map_specs(take, specs)
    left = [p for p in _jax_leaf_paths(jax_tree)
            if p not in consumed and not (p and p[0] in skip)]
    if left:
        raise ValueError(f"{name}: JAX params leaves the port does not "
                         f"consume: {['/'.join(map(str, p)) for p in left]}")
    return out


def from_jax_params(unet_params, vae_params, text_params,
                    config: configs.ModelSetConfig, *, dtype=torch.float32,
                    device="cpu", engine_id: str = "from_jax") -> ModelSet:
    """The JAX package's params trees (numpy or array-likes) -> ModelSet."""
    device = torch.device(device)
    unet_s, vae_s, text_s = _specs(config)
    if len(text_params) != len(text_s):
        raise ValueError(f"{len(text_params)} text towers given, config "
                         f"has {len(text_s)}")
    unet_p = _convert(unet_s, unet_params, "unet", dtype, device)
    vae_p = _convert(vae_s, vae_params, "vae", dtype, device,
                     skip=NOT_PORTED["vae"])
    text_p = [_convert(s, tp, f"text_encoder[{i}]", dtype, device)
              for i, (s, tp) in enumerate(zip(text_s, text_params))]
    return ModelSet(config=config, unet_params=unet_p, vae_params=vae_p,
                    text_params=text_p, tokenizer=FallbackTokenizer(),
                    schedule=sched.scaled_linear_schedule(
                        prediction_type=config.prediction_type),
                    device=device, id=engine_id)
