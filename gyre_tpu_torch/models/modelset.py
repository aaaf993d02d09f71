"""ModelSet: one engine's weights, configs, tokenizer and schedule.

Counterpart of gyre_tpu/models/modelset.py. Three ways to fill one:

  * ``random_modelset``: random weights at a config's full width from a
    seeded ``torch.Generator`` on the target device: linear and conv
    weights uniform in +-1/sqrt(fan_in) (gyre_tpu/models/layers.py's
    inits), norm scales 1, biases 0, CLIP embeddings N(0, 0.02^2) and
    N(0, 0.01^2).
  * ``from_jax_params``: the JAX package's params trees (numpy arrays),
    converted to the port's layouts leaf by leaf: linear (in, out) ->
    (out, in), conv HWIO -> OIHW, the fused convs' HWIO kept. Any leaf of
    the JAX trees that the port does not consume raises.
  * ``models/load.py``: a diffusers-layout checkpoint read from disk.

The bridge and the loader walk the port's spec tree through one strict
converter, ``convert_tree``: a missing or misshapen leaf raises with its
path. All three make every leaf in the given dtype; the leaves the fused
GN -> SiLU -> conv kernels read as f32 (the GroupNorm scale and bias in
front of each fused conv, and its bias; ``Spec.f32``) are then cast up to
f32 from that value, so the three hold the same bits for the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..pipeline import schedule as sched
from ..pipeline.tokenizer import FallbackTokenizer
from . import configs
from . import clip as clip_mod
from . import layers as L
from . import unet as unet_mod
from . import vae as vae_mod

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


def map_specs(fn, tree, path=()):
    """Rebuild a spec tree with fn(path, spec) at every leaf."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def model_specs(cfg: configs.ModelSetConfig):
    """(unet, vae, [text tower, ...]) spec trees of a config."""
    return (unet_mod.param_specs(cfg.unet), vae_mod.param_specs(cfg.vae),
            [clip_mod.param_specs(te) for te in cfg.text_encoders])


def _random_tree(specs, gen, dtype, device):
    def make(s: L.Spec):
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

    return map_specs(lambda _, s: _as_spec_dtype(make(s), s), specs)


def random_tree(specs, seed: int, dtype, device):
    """A params tree of ``specs`` with random weights as random_modelset
    makes them, from its own generator seeded with ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.inference_mode():
        return _random_tree(specs, gen, dtype, device)


def _as_spec_dtype(t, s: L.Spec):
    """A leaf made in the model's dtype; an f32 spec's leaf cast up once,
    here, so it holds exactly the model dtype's value."""
    return t.float() if s.f32 else t


def random_modelset(cfg: configs.ModelSetConfig, seed: int = 0,
                    dtype=torch.bfloat16, device="cuda",
                    engine_id: str = "random") -> ModelSet:
    """Architecture-faithful random weights, made on ``device`` from
    ``seed`` (one generator, leaves drawn in tree order)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    unet_s, vae_s, text_s = model_specs(cfg)
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
                  device="cuda", engine_id: str | None = None) -> ModelSet:
    """random_modelset of a models.configs preset by name
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


def convert_tree(specs, fetch, name: str, dtype, device):
    """The params tree of ``specs``, each leaf ``fetch(path, spec)`` (a
    tensor or array in the port's layout; KeyError naming what it missed
    when the source has no such leaf) checked against its spec's shape,
    moved to ``device``, made in ``dtype`` and, for an f32 spec, cast up
    from that value."""

    def take(path, s: L.Spec):
        where = "/".join(map(str, path))
        try:
            t = torch.as_tensor(fetch(path, s))
        except KeyError as e:
            raise ValueError(f"{name}: no leaf {e.args[0]} (for "
                             f"{where})") from None
        if tuple(t.shape) != s.shape:
            raise ValueError(f"{name}: leaf {where} has shape "
                             f"{tuple(t.shape)} in the port's layout, the "
                             f"port expects {s.shape}")
        # a copy on the device, made in dtype there
        t = t.to(device, copy=True).to(dtype).contiguous()
        return _as_spec_dtype(t, s)

    return map_specs(take, specs)


def round_f32_leaves(tree, specs, dtype):
    """The tree with each f32-spec leaf rounded to ``dtype`` and cast up
    again, as every ModelSet holds them (after arithmetic on the leaves,
    e.g. a model mix)."""
    def fix(path, s: L.Spec):
        t = _get(tree, path)
        return t.to(dtype).float() if s.f32 else t

    return map_specs(fix, specs)


def _from_jax(specs, jax_tree, name: str, dtype, device):
    consumed = set()

    def fetch(path, s: L.Spec):
        try:
            a = np.array(_get(jax_tree, path), dtype=np.float32)
        except (KeyError, IndexError, TypeError):
            raise KeyError("/".join(map(str, path))) from None
        consumed.add(path)
        if s.kind == "linear":
            return a.T
        if s.kind == "conv":
            return a.transpose(3, 2, 0, 1)
        return a

    out = convert_tree(specs, fetch, name, dtype, device)
    left = [p for p in _jax_leaf_paths(jax_tree) if p not in consumed]
    if left:
        raise ValueError(f"{name}: JAX params leaves the port does not "
                         f"consume: {['/'.join(map(str, p)) for p in left]}")
    return out


def controlnet_from_jax(params, cfg: configs.UNetConfig, *,
                       dtype=torch.float32, device="cuda"):
    """The JAX package's ControlNet params tree (numpy) -> the port's, as
    strict as from_jax_params."""
    from . import controlnet

    return _from_jax(controlnet.param_specs(cfg), params, "controlnet",
                     dtype, torch.device(device))


def t2i_adapter_from_jax(params, *, dtype=torch.float32, device="cuda"):
    """The JAX package's T2I-adapter params tree (numpy; a level's "proj"
    None where the channels do not change) -> the port's, as strict as
    from_jax_params."""
    from . import t2i_adapter

    ds = int(params["downscale"])
    levels = params["levels"]
    tree = {"conv_in": params["conv_in"],
            "levels": [{k: v for k, v in lvl.items() if v is not None}
                       for lvl in levels]}
    specs = t2i_adapter.param_specs(
        tuple(np.shape(lvl["blocks"][0]["conv1"]["w"])[-1]
              for lvl in levels),
        cond_channels=np.shape(params["conv_in"]["w"])[2] // (ds * ds),
        n_res_blocks=len(levels[0]["blocks"]), downscale=ds)
    out = _from_jax(specs, tree, "t2i_adapter", dtype, torch.device(device))
    out["downscale"] = ds
    return out


def from_jax_params(unet_params, vae_params, text_params,
                    config: configs.ModelSetConfig, *, dtype=torch.float32,
                    device="cuda", engine_id: str = "from_jax") -> ModelSet:
    """The JAX package's params trees (numpy or array-likes) -> ModelSet."""
    device = torch.device(device)
    unet_s, vae_s, text_s = model_specs(config)
    if len(text_params) != len(text_s):
        raise ValueError(f"{len(text_params)} text towers given, config "
                         f"has {len(text_s)}")
    unet_p = _from_jax(unet_s, unet_params, "unet", dtype, device)
    vae_p = _from_jax(vae_s, vae_params, "vae", dtype, device)
    text_p = [_from_jax(s, tp, f"text_encoder[{i}]", dtype, device)
              for i, (s, tp) in enumerate(zip(text_s, text_params))]
    return ModelSet(config=config, unet_params=unet_p, vae_params=vae_p,
                    text_params=text_p, tokenizer=FallbackTokenizer(),
                    schedule=sched.scaled_linear_schedule(
                        prediction_type=config.prediction_type),
                    device=device, id=engine_id)
