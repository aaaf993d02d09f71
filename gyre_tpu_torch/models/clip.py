"""CLIP text encoder on torch tensors.

Counterpart of gyre_tpu/models/clip.py (text tower only: ``apply`` and
``hidden_for_layer``). The causal mask keeps its attention on the plain
path, as in the JAX package.
"""

from __future__ import annotations

import torch

from gyre_tpu.models.configs import CLIPTextConfig

from . import layers as L

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


def _block(p, x, heads, act):
    b, t, d = x.shape
    hd = d // heads
    h = L.layer_norm(p["ln1"], x)
    q = L.linear(p["attn"]["q"], h).reshape(b, t, heads, hd)
    k = L.linear(p["attn"]["k"], h).reshape(b, t, heads, hd)
    v = L.linear(p["attn"]["v"], h).reshape(b, t, heads, hd)
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    o = L.attention(q, k, v, mask=causal[None, None]).reshape(b, t, d)
    x = x + L.linear(p["attn"]["out"], o)
    h = L.layer_norm(p["ln2"], x)
    h = L.linear(p["fc2"], act(L.linear(p["fc1"], h)))
    return x + h


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
