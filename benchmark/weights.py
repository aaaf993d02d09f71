"""Random weights of a configuration, in the published diffusers /
transformers layouts, made on the device from the run's seed.

``layout(config)`` lists every tensor of the configuration's family
(``families/<family>.py``: for SD the UNet, the VAE and each CLIP text
tower) under its published key (``unet.``, ``vae.``, ``text_encoder.`` ...
prefixes), with its shape and how it is drawn: linear and conv weights
uniform in +-1/sqrt(fan_in), norm scales 1, biases 0, token embeddings
N(0, 0.02^2) and position embeddings N(0, 0.01^2). The building blocks
any family may share are here: linear, conv and norm entries, the SD VAE
(``vae_layout``) and a CLIP text tower (``clip_layout``).
``make(config, seed)`` draws them in the served dtype with one
``torch.Generator`` on the device: one uniform call for all weights and
one normal call for the embeddings, each tensor a view of those two
buffers. Both the program (through its own loader's key maps) and the
plain reference read these same tensors.
"""

from __future__ import annotations

import math

import torch

from . import family

# -------------------------------------------------------------- the layouts


def _lin(out: list, key: str, d_in: int, d_out: int, bias: bool = True):
    out.append((f"{key}.weight", (d_out, d_in), "uniform"))
    if bias:
        out.append((f"{key}.bias", (d_out,), "zeros"))


def _conv(out: list, key: str, c_in: int, c_out: int, k: int = 3):
    out.append((f"{key}.weight", (c_out, c_in, k, k), "uniform"))
    out.append((f"{key}.bias", (c_out,), "zeros"))


def _norm(out: list, key: str, c: int):
    out.append((f"{key}.weight", (c,), "ones"))
    out.append((f"{key}.bias", (c,), "zeros"))


def _resnet(out, key, c_in, c_out, temb: int | None):
    _norm(out, f"{key}.norm1", c_in)
    _conv(out, f"{key}.conv1", c_in, c_out)
    if temb:
        _lin(out, f"{key}.time_emb_proj", temb, c_out)
    _norm(out, f"{key}.norm2", c_out)
    _conv(out, f"{key}.conv2", c_out, c_out)
    if c_in != c_out:
        _conv(out, f"{key}.conv_shortcut", c_in, c_out, k=1)


def vae_layout(v: dict) -> list:
    chs = list(v["block_out_channels"])
    lc = v["latent_channels"]
    layers = v.get("layers_per_block", 2)
    out: list = []

    def attn(key, c):
        _norm(out, f"{key}.group_norm", c)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            _lin(out, f"{key}.{n}", c, c)

    def mid(key, c):
        _resnet(out, f"{key}.mid_block.resnets.0", c, c, None)
        attn(f"{key}.mid_block.attentions.0", c)
        _resnet(out, f"{key}.mid_block.resnets.1", c, c, None)

    _conv(out, "encoder.conv_in", v["in_channels"], chs[0])
    c_prev = chs[0]
    for i, c in enumerate(chs):
        for j in range(layers):
            _resnet(out, f"encoder.down_blocks.{i}.resnets.{j}",
                    c_prev if j == 0 else c, c, None)
        if i < len(chs) - 1:
            _conv(out, f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c)
        c_prev = c
    mid("encoder", chs[-1])
    _norm(out, "encoder.conv_norm_out", chs[-1])
    _conv(out, "encoder.conv_out", chs[-1], 2 * lc)
    if v.get("use_quant_conv", True):
        _conv(out, "quant_conv", 2 * lc, 2 * lc, k=1)
    if v.get("use_post_quant_conv", True):
        _conv(out, "post_quant_conv", lc, lc, k=1)
    _conv(out, "decoder.conv_in", lc, chs[-1])
    mid("decoder", chs[-1])
    c_prev = chs[-1]
    for i, c in enumerate(chs[::-1]):
        for j in range(layers + 1):
            _resnet(out, f"decoder.up_blocks.{i}.resnets.{j}",
                    c_prev if j == 0 else c, c, None)
        if i < len(chs) - 1:
            _conv(out, f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c)
        c_prev = c
    _norm(out, "decoder.conv_norm_out", chs[0])
    _conv(out, "decoder.conv_out", chs[0], v["out_channels"])
    return out


def clip_layout(t: dict) -> list:
    d = t["hidden_size"]
    out: list = [
        ("text_model.embeddings.token_embedding.weight",
         (t["vocab_size"], d), "normal:0.02"),
        ("text_model.embeddings.position_embedding.weight",
         (t["max_position_embeddings"], d), "normal:0.01")]
    for i in range(t["num_hidden_layers"]):
        b = f"text_model.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(out, f"{b}.self_attn.{n}", d, d)
        _norm(out, f"{b}.layer_norm1", d)
        _lin(out, f"{b}.mlp.fc1", d, t["intermediate_size"])
        _lin(out, f"{b}.mlp.fc2", t["intermediate_size"], d)
        _norm(out, f"{b}.layer_norm2", d)
    _norm(out, "text_model.final_layer_norm", d)
    if "CLIPTextModelWithProjection" in t.get("architectures", []):
        _lin(out, "text_projection", d, t["projection_dim"], bias=False)
    return out


def text_towers(config: dict) -> list[str]:
    """The text towers' names in order (``text_encoder``,
    ``text_encoder_2``, ...)."""
    return sorted((k for k in config if k.startswith("text_encoder")),
                  key=lambda k: (len(k), k))


def layout(config: dict) -> list:
    """[(key, shape, kind)] of every tensor, keys prefixed by part: the
    ``layout`` of the configuration's family (``family.py``)."""
    return family.code(config).layout(config)


def count(config: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(config))


# --------------------------------------------------------------- the draws


def make(config: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{key: tensor} of ``layout(config)`` drawn from ``seed`` on
    ``device`` in ``dtype``."""
    entries = layout(config)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_uni = sum(math.prod(s) for _, s, k in entries if k == "uniform")
    n_nrm = sum(math.prod(s) for _, s, k in entries
                if k.startswith("normal"))
    with torch.no_grad():
        uni = torch.rand(n_uni, generator=gen, device=device, dtype=dtype)
        nrm = torch.randn(n_nrm, generator=gen, device=device, dtype=dtype)
        state, ou, on = {}, 0, 0
        for key, shape, kind in entries:
            size = math.prod(shape)
            if kind == "uniform":
                t = uni[ou:ou + size].view(shape)
                ou += size
                bound = (size // shape[0]) ** -0.5
                t.mul_(2.0 * bound).sub_(bound)
            elif kind.startswith("normal"):
                t = nrm[on:on + size].view(shape)
                on += size
                t.mul_(float(kind.split(":")[1]))
            elif kind == "ones":
                t = torch.ones(shape, device=device, dtype=dtype)
            else:
                t = torch.zeros(shape, device=device, dtype=dtype)
            state[key] = t
    return state


def part(state: dict, name: str) -> dict:
    """The tensors of one part (``unet``, ``vae``, ``text_encoder`` ...)
    under their keys within that part."""
    pre = name + "."
    return {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}
