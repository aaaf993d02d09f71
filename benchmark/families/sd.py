"""The Stable Diffusion family: a conditional UNet (diffusers'
UNet2DConditionModel) over one or two CLIP text towers and the SD VAE
(AutoencoderKL), sampled by k-diffusion over a scaled-linear schedule under
parallel classifier-free guidance.

What the benchmark needs of it (``family.py``): the weights' layout, the
work of a request and of a chunk the dispatcher ran, and the port's served
model set. The VAE's and the towers' parts are the shared building blocks
of ``weights.py`` and ``flops.py``; the UNet's are here.
"""

from __future__ import annotations

from benchmark import flops as F
from benchmark import weights as W

# -------------------------------------------------------------- the layout


def _transformer_layout(out, key, c, ctx, layers: int, linear_proj: bool):
    W._norm(out, f"{key}.norm", c)
    proj = W._lin if linear_proj else (
        lambda o, k, a, b: W._conv(o, k, a, b, k=1))
    proj(out, f"{key}.proj_in", c, c)
    for i in range(layers):
        b = f"{key}.transformer_blocks.{i}"
        for n, kv in (("attn1", c), ("attn2", ctx)):
            W._lin(out, f"{b}.{n}.to_q", c, c, bias=False)
            W._lin(out, f"{b}.{n}.to_k", kv, c, bias=False)
            W._lin(out, f"{b}.{n}.to_v", kv, c, bias=False)
            W._lin(out, f"{b}.{n}.to_out.0", c, c)
        for n in ("norm1", "norm2", "norm3"):
            W._norm(out, f"{b}.{n}", c)
        W._lin(out, f"{b}.ff.net.0.proj", c, 8 * c)
        W._lin(out, f"{b}.ff.net.2", 4 * c, c)
    proj(out, f"{key}.proj_out", c, c)


def unet_plan(u: dict) -> dict:
    """The UNet's structure from its diffusers config: per level its
    channels, heads and transformer depth, and whether it has attention."""
    boc = list(u["block_out_channels"])
    n = len(boc)
    heads = u.get("num_attention_heads") or u.get("attention_head_dim", 8)
    heads = [heads] * n if isinstance(heads, int) else list(heads)
    depth = u.get("transformer_layers_per_block", 1)
    depth = [depth] * n if isinstance(depth, int) else list(depth)
    down_attn = ["CrossAttn" in t for t in u["down_block_types"]]
    up_attn = ["CrossAttn" in t for t in u["up_block_types"]]
    return {"channels": boc, "heads": heads, "depth": depth,
            "down_attn": down_attn, "up_attn": up_attn,
            "layers": int(u.get("layers_per_block", 2)),
            "temb": int(u.get("time_embedding_dim") or boc[0] * 4),
            "ctx": int(u["cross_attention_dim"]),
            "linear_proj": bool(u.get("use_linear_projection", False)),
            "text_time": u.get("addition_embed_type") == "text_time"}


def unet_layout(u: dict) -> list:
    p = unet_plan(u)
    boc, n, temb = p["channels"], len(p["channels"]), p["temb"]
    out: list = []
    W._conv(out, "conv_in", u["in_channels"], boc[0])
    W._lin(out, "time_embedding.linear_1", boc[0], temb)
    W._lin(out, "time_embedding.linear_2", temb, temb)
    if p["text_time"]:
        W._lin(out, "add_embedding.linear_1",
               u["projection_class_embeddings_input_dim"], temb)
        W._lin(out, "add_embedding.linear_2", temb, temb)
    c_prev = boc[0]
    for i, c in enumerate(boc):
        for j in range(p["layers"]):
            W._resnet(out, f"down_blocks.{i}.resnets.{j}",
                      c_prev if j == 0 else c, c, temb)
            if p["down_attn"][i]:
                _transformer_layout(out, f"down_blocks.{i}.attentions.{j}",
                                    c, p["ctx"], p["depth"][i],
                                    p["linear_proj"])
        if i < n - 1:
            W._conv(out, f"down_blocks.{i}.downsamplers.0.conv", c, c)
        c_prev = c
    W._resnet(out, "mid_block.resnets.0", boc[-1], boc[-1], temb)
    _transformer_layout(out, "mid_block.attentions.0", boc[-1], p["ctx"],
                        p["depth"][-1], p["linear_proj"])
    W._resnet(out, "mid_block.resnets.1", boc[-1], boc[-1], temb)
    rev = boc[::-1]
    rev_depth = p["depth"][::-1]
    c_prev = rev[0]
    for i, c in enumerate(rev):
        c_in = rev[min(i + 1, n - 1)]
        for j in range(p["layers"] + 1):
            skip = c_in if j == p["layers"] else c
            W._resnet(out, f"up_blocks.{i}.resnets.{j}",
                      (c_prev if j == 0 else c) + skip, c, temb)
            if p["up_attn"][i]:
                _transformer_layout(out, f"up_blocks.{i}.attentions.{j}", c,
                                    p["ctx"], rev_depth[i], p["linear_proj"])
        if i < n - 1:
            W._conv(out, f"up_blocks.{i}.upsamplers.0.conv", c, c)
        c_prev = c
    W._norm(out, "conv_norm_out", boc[0])
    W._conv(out, "conv_out", boc[0], u["out_channels"])
    return out


def layout(config: dict) -> list:
    """[(key, shape, kind)] of every tensor, keys prefixed by part: the
    UNet, the VAE and each CLIP text tower."""
    parts = [("unet", unet_layout(config["unet"])),
             ("vae", W.vae_layout(config["vae"]))]
    parts += [(name, W.clip_layout(config[name]))
              for name in W.text_towers(config)]
    return [(f"{part}.{key}", shape, kind)
            for part, entries in parts for key, shape, kind in entries]


# ---------------------------------------------------------------- the work


def _transformer_work(w: F.Work, b, hw, c, ctx_len, ctx_dim, heads, layers):
    """proj_in, ``layers`` blocks (self-attention, cross-attention, GEGLU
    feed-forward), proj_out. Each attention is one K1 launch."""
    d = c // heads
    t = b * hw
    w.flops += 2 * F._lin(t, c, c)                     # proj_in, proj_out
    for _ in range(layers):
        w.flops += 4 * F._lin(t, c, c) + F._attn(b, heads, hw, hw, d)
        w.flops += 2 * F._lin(t, c, c) + 2 * F._lin(b * ctx_len, ctx_dim, c)
        w.flops += F._attn(b, heads, hw, ctx_len, d)               # cross
        w.flops += F._lin(t, c, 8 * c) + F._lin(t, 4 * c, c)       # GEGLU
        w.k1 += [(b, heads, hw, hw, d), (b, heads, hw, ctx_len, d)]


def unet_call(u: dict, rows: int, h: int, w_: int,
              ctx_len: int = 77) -> F.Work:
    """One UNet call on ``rows`` rows of h x w latents."""
    boc = list(u["block_out_channels"])
    n = len(boc)
    heads = u.get("num_attention_heads") or u.get("attention_head_dim", 8)
    heads = [heads] * n if isinstance(heads, int) else list(heads)
    depth = u.get("transformer_layers_per_block", 1)
    depth = [depth] * n if isinstance(depth, int) else list(depth)
    layers = u.get("layers_per_block", 2)
    temb = int(u.get("time_embedding_dim") or boc[0] * 4)
    ctx = int(u["cross_attention_dim"])
    w = F.Work()
    w.flops += F._lin(rows, boc[0], temb) + F._lin(rows, temb, temb)
    if u.get("addition_embed_type") == "text_time":
        w.flops += F._lin(rows, u["projection_class_embeddings_input_dim"],
                          temb) + F._lin(rows, temb, temb)
    hw = h * w_
    w.flops += F._conv(rows * hw, u["in_channels"], boc[0])
    skips = [boc[0]]
    c_prev = boc[0]
    for i, c in enumerate(boc):
        for j in range(layers):
            F._resnet(w, rows, hw, c_prev if j == 0 else c, c, temb)
            if "CrossAttn" in u["down_block_types"][i]:
                _transformer_work(w, rows, hw, c, ctx_len, ctx, heads[i],
                                  depth[i])
            skips.append(c)
        if i < n - 1:
            hw //= 4
            w.flops += F._conv(rows * hw, c, c)
            skips.append(c)
        c_prev = c
    F._resnet(w, rows, hw, boc[-1], boc[-1], temb)
    _transformer_work(w, rows, hw, boc[-1], ctx_len, ctx, heads[-1],
                      depth[-1])
    F._resnet(w, rows, hw, boc[-1], boc[-1], temb)
    c_prev = boc[-1]
    for i, c in enumerate(boc[::-1]):
        for j in range(layers + 1):
            F._resnet(w, rows, hw, c_prev + skips.pop(), c, temb)
            c_prev = c
            if "CrossAttn" in u["up_block_types"][i]:
                _transformer_work(w, rows, hw, c, ctx_len, ctx,
                                  heads[::-1][i], depth[::-1][i])
        if i < n - 1:
            hw *= 4
            w.flops += F._conv(rows * hw, c, c)
    w.flops += F._conv(rows * hw, boc[0], u["out_channels"])
    return w


def request(config: dict, images: int, height: int, width: int,
            steps: int) -> F.Work:
    """The model work of a batch of ``images`` txt2img requests under
    parallel CFG: each tower on the prompt and the negative prompt, 2 x
    images UNet rows at every step, the decode of each image."""
    h, w_ = height // 8, width // 8
    work = F.Work()
    for name in W.text_towers(config):
        work.add(F.text_tower(config[name], 2 * images))
    work.add(unet_call(config["unet"], 2 * images, h, w_), steps)
    work.add(F.vae_decode(config["vae"], images, h, w_))
    return work


def chunk_work(config: dict, chunk) -> tuple[F.Work, float]:
    """(the kernels' work at the rows and size the chunk ran, padding
    included; the model FLOPs of its real rows) of one ``program.Chunk``."""
    h, w_ = chunk.height // 8, chunk.width // 8
    rows, real = chunk.rows, chunk.rows - chunk.pad
    if chunk.kind == "decode":
        return (F.vae_decode(config["vae"], rows, h, w_),
                F.vae_decode(config["vae"], real, h, w_).flops)
    calls = chunk.end - chunk.first
    ran = F.Work().add(unet_call(config["unet"], 2 * rows, h, w_), calls)
    useful = unet_call(config["unet"], 2 * real, h, w_).flops * calls
    if chunk.first == 0:
        useful += sum(F.text_tower(config[t], 2 * real).flops
                      for t in W.text_towers(config))
    return ran, useful


# ------------------------------------------------------ the served models


def served_config(config: dict):
    """The port's ModelSetConfig for ``config``: its preset (the server's
    engines name presets), checked against the published widths."""
    from gyre_tpu_torch.models import configs

    cfg = configs.PRESETS[config["preset"]]
    u, v = config["unet"], config["vae"]
    want = configs.unet_config_from_diffusers(u, cfg.unet)
    for f in ("block_out_channels", "num_heads", "cross_attention_dim",
              "in_channels", "out_channels", "layers_per_block",
              "attn_levels", "linear_projection", "addition_embed_dim",
              "addition_time_dim", "addition_time_ids", "time_embed_dim",
              "norm_groups"):
        if getattr(want, f) != getattr(cfg.unet, f):
            raise ValueError(f"preset {config['preset']}: unet {f} "
                             f"{getattr(cfg.unet, f)} != published "
                             f"{getattr(want, f)}")
    levels = [d for d, a in zip(want.transformer_layers, want.attn_levels)
              if a]
    if levels != [d for d, a in zip(cfg.unet.transformer_layers,
                                    cfg.unet.attn_levels) if a]:
        raise ValueError(f"preset {config['preset']}: transformer depths "
                         "differ from the published config")
    if list(v["block_out_channels"]) != list(cfg.vae.block_out_channels) \
            or float(v.get("scaling_factor", 0.18215)) != \
            cfg.vae.scaling_factor:
        raise ValueError(f"preset {config['preset']}: VAE differs")
    towers = W.text_towers(config)
    if len(towers) != len(cfg.text_encoders):
        raise ValueError(f"preset {config['preset']}: {len(towers)} towers")
    for name, te in zip(towers, cfg.text_encoders):
        t = config[name]
        if (t["hidden_size"], t["num_hidden_layers"],
                t["num_attention_heads"], t["intermediate_size"],
                t["hidden_act"]) != (te.hidden_size, te.num_layers,
                                     te.num_heads, te.intermediate_size,
                                     te.activation):
            raise ValueError(f"preset {config['preset']}: {name} differs")
    if int(config["serving"]["clip_layer"]) != cfg.clip_layer:
        raise ValueError(f"preset {config['preset']}: clip_layer differs")
    return cfg


def serve(config: dict, state: dict, device, dtype, engine_id: str):
    """The port's ModelSet from the benchmark's weights, through
    models/load.py's key maps (each leaf copied to the device in
    ``dtype``), with no file written. This and ``served_config`` are the
    family's only imports of ``gyre_tpu_torch``."""
    import torch

    from gyre_tpu_torch.models import load as L
    from gyre_tpu_torch.models.modelset import ModelSet, model_specs
    from gyre_tpu_torch.pipeline import schedule as sched
    from gyre_tpu_torch.pipeline.tokenizer import load_tokenizer

    cfg = served_config(config)
    unet_s, vae_s, text_s = model_specs(cfg)
    unet = L.load_tree(unet_s, W.part(state, "unet"), L.unet_keys, "unet",
                       dtype, device)
    vae = L.load_tree(vae_s, W.part(state, "vae"), L.vae_keys, "vae", dtype,
                      device)
    text = [L.load_tree(s, W.part(state, name), L.clip_keys, name, dtype,
                        device)
            for s, name in zip(text_s, W.text_towers(config))]
    s = config["scheduler"]
    schedule = sched.scaled_linear_schedule(
        num_timesteps=s["num_train_timesteps"], beta_start=s["beta_start"],
        beta_end=s["beta_end"], prediction_type=s["prediction_type"])
    return ModelSet(config=cfg, unet_params=unet, vae_params=vae,
                    text_params=text, tokenizer=load_tokenizer(None),
                    schedule=schedule, device=torch.device(device),
                    id=engine_id)
