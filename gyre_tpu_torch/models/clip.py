"""CLIP text encoder and vision tower on torch tensors.

Counterpart of gyre_tpu/models/clip.py: the text tower (``apply`` and
``hidden_for_layer``; its causal mask keeps its attention on the plain
path, as in the JAX package) and the vision tower (``vision_apply``, the
non-causal blocks through K1 on the card) with its configs and CLIP's
preprocessing constants, which the port keeps a copy of since the JAX
module imports JAX. The vision tower's pooled output, projection and L2
normalisation are computed in f32 whatever the weights' dtype: the safety
checker thresholds cosines of these embeddings at a margin of 0.01.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import layers as L
from .configs import CLIPTextConfig

Params = dict


def param_specs(cfg: CLIPTextConfig) -> Params:
    d = cfg.hidden_size

    def block():
        return {
            "ln1": L.norm_spec(d),
            "attn": {n: L.linear_spec(d, d) for n in ("q", "k", "v", "out")},
            "ln2": L.norm_spec(d),
            "fc1": L.linear_spec(d, cfg.intermediate_size),
            "fc2": L.linear_spec(cfg.intermediate_size, d),
        }

    p: Params = {
        "token_embedding": L.Spec("normal", (cfg.vocab_size, d), 0.02),
        "position_embedding": L.Spec(
            "normal", (cfg.max_position_embeddings, d), 0.01),
        "blocks": [block() for _ in range(cfg.num_layers)],
        "final_ln": L.norm_spec(d),
    }
    if cfg.projection_dim:
        p["text_projection"] = L.linear_spec(d, cfg.projection_dim,
                                             bias=False)
    return p


def _self_attention(p, h, heads, mask=None):
    """Self-attention of a block's ``attn`` params; split weights
    (``L.Shards``, parallel/mesh.py) run shard by shard."""
    if isinstance(p["q"]["w"], L.Shards):
        return L.tp_attention(p, h, h, heads, mask=mask)
    b, t, d = h.shape
    hd = d // heads
    q = L.linear(p["q"], h).reshape(b, t, heads, hd)
    k = L.linear(p["k"], h).reshape(b, t, heads, hd)
    v = L.linear(p["v"], h).reshape(b, t, heads, hd)
    return L.linear(p["out"], L.attention(q, k, v, mask=mask).reshape(b, t,
                                                                      d))


def _mlp(p, h, act):
    def hidden(p_in, x):
        return act(L.linear(p_in, x))

    if isinstance(p["fc1"]["w"], L.Shards):
        return L.tp_mlp(p["fc1"], p["fc2"], h, hidden)
    return L.linear(p["fc2"], hidden(p["fc1"], h))


def _block(p, x, heads, act):
    t = x.shape[1]
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    x = x + _self_attention(p["attn"], L.layer_norm(p["ln1"], x), heads,
                            mask=causal[None, None])
    return x + _mlp(p, L.layer_norm(p["ln2"], x), act)


def apply(params: Params, cfg: CLIPTextConfig, input_ids, dtype=None):
    """input_ids [B, T<=77] (int64) -> dict with
      hidden_states: list of [B,T,D] per layer (post-block, pre-final-LN)
      last: final-LN output [B,T,D]
      pooled: EOS-token embedding (projected if cfg.projection_dim)
    dtype: compute dtype (default: the embeddings' dtype)."""
    act = L.quick_gelu if cfg.activation == "quick_gelu" else L.gelu
    t = input_ids.shape[-1]
    x = params["token_embedding"][input_ids] + \
        params["position_embedding"][:t][None]
    if dtype is not None:
        x = x.to(dtype)
    hidden = []
    for blk in params["blocks"]:
        x = _block(blk, x, cfg.num_heads, act)
        hidden.append(x)
    last = L.layer_norm(params["final_ln"], x)
    eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
    pooled = last[torch.arange(last.shape[0], device=last.device), eos_pos]
    if "text_projection" in params:
        pooled = L.linear(params["text_projection"], pooled)
    return {"hidden_states": hidden, "last": last, "pooled": pooled}


def hidden_for_layer(params, cfg, out: dict, clip_layer: int):
    """clip_layer: -1 = final LN output; -n = nth-from-last block output
    with the final layer norm applied (SD2's penultimate convention)."""
    if clip_layer == -1:
        return out["last"]
    if not -cfg.num_layers <= clip_layer < 0:
        raise ValueError(
            f"clip_layer {clip_layer} out of range for a {cfg.num_layers}-"
            f"layer tower (expected -1..-{cfg.num_layers})")
    h = out["hidden_states"][clip_layer + cfg.num_layers]
    return L.layer_norm(params["final_ln"], h)


# ------------------------------------------------------------ vision tower


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    activation: str = "quick_gelu"


CLIP_VISION_L = CLIPVisionConfig()
CLIP_VISION_TEST = CLIPVisionConfig(
    image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, projection_dim=32)

# CLIP preprocessing constants
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def vision_specs(cfg: CLIPVisionConfig) -> Params:
    """The vision tower's spec tree: the patch embedding (a stride-patch
    conv, OIHW, no bias), the class token, the positions, the pre- and
    post-LayerNorms, the text tower's block layout and the projection."""
    d = cfg.hidden_size
    blocks = param_specs(CLIPTextConfig(
        hidden_size=d, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        activation=cfg.activation))["blocks"]
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    return {
        "patch_embed": {"w": L.Spec(
            "conv", (d, 3, cfg.patch_size, cfg.patch_size))},
        "class_embed": L.Spec("normal", (d,), 0.02),
        "position_embedding": L.Spec("normal", (n_patches + 1, d), 0.01),
        "pre_ln": L.norm_spec(d),
        "blocks": blocks,
        "post_ln": L.norm_spec(d),
        "visual_projection": L.linear_spec(d, cfg.projection_dim,
                                           bias=False),
    }


def random_vision(cfg: CLIPVisionConfig = CLIP_VISION_L, seed: int = 0,
                  dtype=torch.bfloat16, device="cuda") -> Params:
    """A random vision tower as models/modelset.py makes weights."""
    from .modelset import random_tree

    return random_tree(vision_specs(cfg), seed, dtype, device)


def _vision_block(p, x, heads, act):
    """Non-causal transformer block (the text blocks' params layout)."""
    x = x + _self_attention(p["attn"], L.layer_norm(p["ln1"], x), heads)
    return x + _mlp(p, L.layer_norm(p["ln2"], x), act)


def preprocess_image(images):
    """[B,H,W,3] in [0,1] -> CLIP-normalised."""
    mean = torch.tensor(IMAGE_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGE_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def vision_apply(params: Params, cfg: CLIPVisionConfig, images,
                 normalize: bool = True):
    """images [B,S,S,3], CLIP-preprocessed -> dict with image_embeds
    [B, proj] and pooled [B, D] (both f32), tokens [B, N+1, D] (the
    weights' dtype, which the tower computes in)."""
    act = L.quick_gelu if cfg.activation == "quick_gelu" else L.gelu
    b = images.shape[0]
    x = images.to(params["patch_embed"]["w"].dtype)
    h = L.conv2d(params["patch_embed"], x, stride=cfg.patch_size,
                 padding=0)
    h = h.reshape(b, -1, cfg.hidden_size)
    cls = params["class_embed"].to(h.dtype).expand(b, 1, cfg.hidden_size)
    h = torch.cat([cls, h], dim=1)
    h = h + params["position_embedding"][None, :h.shape[1]].to(h.dtype)
    h = L.layer_norm(params["pre_ln"], h)
    for blk in params["blocks"]:
        h = _vision_block(blk, h, cfg.num_heads, act)
    pooled = L.layer_norm(params["post_ln"], h[:, 0].float())
    embeds = F.linear(pooled, params["visual_projection"]["w"].float())
    if normalize:
        embeds = embeds / torch.linalg.vector_norm(embeds, dim=-1,
                                                   keepdim=True)
    return {"image_embeds": embeds, "pooled": pooled, "tokens": h}
