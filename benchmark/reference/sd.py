"""Plain PyTorch reference of a txt2img request: CLIP text towers, the
conditional UNet, DPM++ 2M with classifier-free guidance, the VAE decoder
and the uint8 quantisation, from weights in the published diffusers /
transformers layouts and the configuration's own config dicts.

Written from the published architectures (diffusers' UNet2DConditionModel
and AutoencoderKL, transformers' CLIPTextModel) and from the served
request's semantics, independently of the program under test: it imports
nothing of it and reads only the weights the benchmark made. Everything is
NCHW and float32, with TF32 off, unless a ``quant`` function is given: the
control passes one that rounds each matmul's and conv's operands to fp8.

The request's semantics, as the server defines them:

* prompts are tokenised one id a word (the word-hash ids the server uses
  for engines without vocabulary files: 1000 + crc32(word) % 48000),
  between BOS 49406 and EOS 49407, padded with EOS to 77;
* the context is each tower's hidden state at ``clip_layer`` (-1: the
  final LayerNorm's output; -2: the penultimate block's output through
  the final LayerNorm), the towers' contexts side by side; SDXL's pooled
  text is the last tower's final-LN output at the first EOS, projected;
* the initial latents are sigma_max times JAX's ``random.normal`` of the
  key PRNGKey(seed) folded with crc32("init") and step 0 (threefry-2x32,
  partitionable counters), NHWC;
* sigmas: k-diffusion's linspace over the scaled-linear schedule's
  timesteps, log-interpolated, then 0; the UNet sees t = sigma's
  fractional timestep and x / sqrt(sigma^2 + 1); x0 = x - sigma * eps;
* CFG: uncond and cond rows in one call, eps = u + scale * (c - u);
* the image is (decode(z / scaling_factor) * 0.5 + 0.5) clamped to [0, 1],
  then (x * 255 + 0.5) truncated to uint8.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch
import torch.nn.functional as F

BOS, EOS = 49406, 49407


# ---------------------------------------------------------------- tokens


def token_ids(text: str, length: int = 77) -> list[int]:
    words = text.lower().split()[:length - 2]
    ids = [BOS] + [1000 + zlib.crc32(w.encode()) % 48000 for w in words]
    ids.append(EOS)
    return ids + [EOS] * (length - len(ids))


# ----------------------------------------------------------------- noise

_M32 = 0xFFFFFFFF


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint64 numpy arrays of 32-bit words."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (np.uint64(k0), np.uint64(k1), np.uint64(k0 ^ k1 ^ 0x1BD11BDA))
    m = np.uint64(_M32)
    x0 = (np.asarray(x0, np.uint64) + ks[0]) & m
    x1 = (np.asarray(x1, np.uint64) + ks[1]) & m
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & m
            x1 = (((x1 << np.uint64(r)) | (x1 >> np.uint64(32 - r))) & m) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & m
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & m
    return x0, x1


def _fold_in(key, data: int):
    a, b = _threefry(key[0], key[1], 0, int(data) & _M32)
    return int(a), int(b)


# M. Giles' single-precision erfinv polynomial (the one XLA evaluates)
_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
        1.50140941)
_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
        2.83297682)


def _erfinv(x):
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < 5.0
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_LT5[0]), np.float32(_GE5[0]))
    for a, b in zip(_LT5[1:], _GE5[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)) + p * w
    return (p * x).astype(np.float32)


def initial_noise(seed: int, shape) -> np.ndarray:
    """f32 standard normal of shape (H, W, C) for a request seed."""
    key = (0, int(seed) & _M32)
    key = _fold_in(key, zlib.crc32(b"init") & 0x7FFFFFFF)
    key = _fold_in(key, 0)
    n = math.prod(shape)
    a, b = _threefry(key[0], key[1], np.zeros(n, np.uint64),
                     np.arange(n, dtype=np.uint64))
    bits = (a ^ b).astype(np.uint32)
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    u = u - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(u * np.float32(2.0) + lo, lo)
    return (_erfinv(u) * np.float32(np.sqrt(2.0))).reshape(shape)


# -------------------------------------------------------------- schedule


def _log_sigmas(scheduler: dict) -> np.ndarray:
    """log sigma of each training timestep of the scaled-linear schedule."""
    betas = np.linspace(scheduler["beta_start"] ** 0.5,
                        scheduler["beta_end"] ** 0.5,
                        scheduler["num_train_timesteps"],
                        dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    return np.log(np.sqrt((1.0 - ac) / ac))


def sigmas(scheduler: dict, steps: int) -> np.ndarray:
    log_s = _log_sigmas(scheduler)
    t = np.linspace(len(log_s) - 1, 0.0, steps)
    lo, hi = np.floor(t).astype(int), np.ceil(t).astype(int)
    w = t - lo
    return np.append(np.exp((1 - w) * log_s[lo] + w * log_s[hi]), 0.0)


def sigma_to_t(scheduler: dict, sigma: float) -> float:
    log_s = _log_sigmas(scheduler)
    return float(np.interp(np.log(sigma), log_s,
                           np.arange(len(log_s), dtype=np.float64)))


# ---------------------------------------------------------------- layers


class Net:
    """The reference's layers over one part's weights, in f32, each
    matmul's and conv's operands through ``quant`` (identity by
    default)."""

    def __init__(self, state: dict, quant=None):
        self.w = state
        self.q = quant or (lambda t: t)

    def p(self, key):
        return self.w[key].float()

    def linear(self, key, x, bias=True):
        b = self.p(key + ".bias") if bias and key + ".bias" in self.w \
            else None
        return F.linear(self.q(x), self.q(self.p(key + ".weight")), b)

    def conv(self, key, x, stride=1, padding=None):
        w = self.q(self.p(key + ".weight"))
        pad = w.shape[-1] // 2 if padding is None else padding
        return F.conv2d(self.q(x), w, self.p(key + ".bias"), stride=stride,
                        padding=pad)

    def group_norm(self, key, x, groups, eps):
        return F.group_norm(x, groups, self.p(key + ".weight"),
                            self.p(key + ".bias"), eps)

    def layer_norm(self, key, x, eps=1e-5):
        return F.layer_norm(x, (x.shape[-1],), self.p(key + ".weight"),
                            self.p(key + ".bias"), eps)

    def attention(self, q, k, v, heads, causal=False):
        """[B, T, C] q and [B, S, C] k, v -> [B, T, C]."""
        b, t, c = q.shape
        d = c // heads
        q, k, v = (self.q(z).reshape(b, -1, heads, d).transpose(1, 2)
                   for z in (q, k, v))
        logits = q @ k.transpose(-1, -2) / math.sqrt(d)
        if causal:
            mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
            logits = logits.masked_fill(~mask, float("-inf"))
        out = self.q(logits.softmax(-1)) @ v
        return out.transpose(1, 2).reshape(b, t, c)


def _timestep_embedding(t, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ------------------------------------------------------------------ CLIP


def clip_forward(net: Net, cfg: dict, ids, layer: int):
    """ids [B, 77] -> (context [B, 77, D] at ``layer``, pooled [B, P])."""
    act = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
           "gelu": F.gelu}[cfg["hidden_act"]]
    heads = cfg["num_attention_heads"]
    pre = "text_model."
    x = net.p(pre + "embeddings.token_embedding.weight")[ids] + \
        net.p(pre + "embeddings.position_embedding.weight")[None,
                                                            :ids.shape[1]]
    hidden = []
    for i in range(cfg["num_hidden_layers"]):
        b = f"{pre}encoder.layers.{i}"
        h = net.layer_norm(f"{b}.layer_norm1", x)
        x = x + net.linear(f"{b}.self_attn.out_proj", net.attention(
            net.linear(f"{b}.self_attn.q_proj", h),
            net.linear(f"{b}.self_attn.k_proj", h),
            net.linear(f"{b}.self_attn.v_proj", h), heads, causal=True))
        h = net.layer_norm(f"{b}.layer_norm2", x)
        x = x + net.linear(f"{b}.mlp.fc2", act(net.linear(f"{b}.mlp.fc1",
                                                          h)))
        hidden.append(x)
    last = net.layer_norm(pre + "final_layer_norm", x)
    ctx = last if layer == -1 else net.layer_norm(
        pre + "final_layer_norm", hidden[layer + len(hidden)])
    eos = (ids == EOS).int().argmax(dim=-1)
    pooled = last[torch.arange(ids.shape[0], device=ids.device), eos]
    if "text_projection.weight" in net.w:
        pooled = net.linear("text_projection", pooled, bias=False)
    return ctx, pooled


# ------------------------------------------------------------------ UNet


def _resnet(net, key, x, temb, groups, eps):
    h = net.conv(f"{key}.conv1", F.silu(net.group_norm(f"{key}.norm1", x,
                                                       groups, eps)))
    if temb is not None:
        h = h + net.linear(f"{key}.time_emb_proj",
                           F.silu(temb))[:, :, None, None]
    h = net.conv(f"{key}.conv2", F.silu(net.group_norm(f"{key}.norm2", h,
                                                       groups, eps)))
    if f"{key}.conv_shortcut.weight" in net.w:
        x = net.conv(f"{key}.conv_shortcut", x)
    return x + h


def _transformer(net, key, x, ctx, heads, layers, linear_proj, groups):
    b, c, hh, ww = x.shape
    res = x
    x = net.group_norm(f"{key}.norm", x, groups, 1e-6)
    if linear_proj:
        x = net.linear(f"{key}.proj_in",
                       x.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
    else:
        x = net.conv(f"{key}.proj_in", x).permute(0, 2, 3, 1).reshape(
            b, hh * ww, c)
    for i in range(layers):
        blk = f"{key}.transformer_blocks.{i}"
        h = net.layer_norm(f"{blk}.norm1", x)
        x = x + net.linear(f"{blk}.attn1.to_out.0", net.attention(
            net.linear(f"{blk}.attn1.to_q", h, bias=False),
            net.linear(f"{blk}.attn1.to_k", h, bias=False),
            net.linear(f"{blk}.attn1.to_v", h, bias=False), heads))
        h = net.layer_norm(f"{blk}.norm2", x)
        x = x + net.linear(f"{blk}.attn2.to_out.0", net.attention(
            net.linear(f"{blk}.attn2.to_q", h, bias=False),
            net.linear(f"{blk}.attn2.to_k", ctx, bias=False),
            net.linear(f"{blk}.attn2.to_v", ctx, bias=False), heads))
        h = net.layer_norm(f"{blk}.norm3", x)
        val, gate = net.linear(f"{blk}.ff.net.0.proj", h).chunk(2, dim=-1)
        x = x + net.linear(f"{blk}.ff.net.2", val * F.gelu(gate))
    if linear_proj:
        x = net.linear(f"{key}.proj_out", x)
        x = x.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    else:
        x = net.conv(f"{key}.proj_out",
                     x.reshape(b, hh, ww, c).permute(0, 3, 1, 2))
    return x + res


def unet_forward(net: Net, u: dict, x, t, ctx, added=None):
    """eps of NCHW x [B, C, h, w] at fractional timesteps t [B]."""
    boc = list(u["block_out_channels"])
    n = len(boc)
    heads = u.get("num_attention_heads") or u.get("attention_head_dim", 8)
    heads = [heads] * n if isinstance(heads, int) else list(heads)
    depth = u.get("transformer_layers_per_block", 1)
    depth = [depth] * n if isinstance(depth, int) else list(depth)
    layers = u.get("layers_per_block", 2)
    groups, eps = u.get("norm_num_groups", 32), u.get("norm_eps", 1e-5)
    lp = bool(u.get("use_linear_projection", False))
    temb = net.linear("time_embedding.linear_2", F.silu(net.linear(
        "time_embedding.linear_1", _timestep_embedding(t, boc[0]))))
    if u.get("addition_embed_type") == "text_time":
        tid = _timestep_embedding(added["time_ids"].reshape(-1),
                                  u["addition_time_embed_dim"])
        aug = torch.cat([added["text_embeds"],
                         tid.reshape(x.shape[0], -1)], dim=-1)
        temb = temb + net.linear("add_embedding.linear_2", F.silu(
            net.linear("add_embedding.linear_1", aug)))
    h = net.conv("conv_in", x)
    skips = [h]
    for i in range(n):
        attn = "CrossAttn" in u["down_block_types"][i]
        for j in range(layers):
            h = _resnet(net, f"down_blocks.{i}.resnets.{j}", h, temb, groups,
                        eps)
            if attn:
                h = _transformer(net, f"down_blocks.{i}.attentions.{j}", h,
                                 ctx, heads[i], depth[i], lp, groups)
            skips.append(h)
        if i < n - 1:
            h = net.conv(f"down_blocks.{i}.downsamplers.0.conv", h, stride=2,
                         padding=1)
            skips.append(h)
    h = _resnet(net, "mid_block.resnets.0", h, temb, groups, eps)
    h = _transformer(net, "mid_block.attentions.0", h, ctx, heads[-1],
                     depth[-1], lp, groups)
    h = _resnet(net, "mid_block.resnets.1", h, temb, groups, eps)
    for i in range(n):
        attn = "CrossAttn" in u["up_block_types"][i]
        for j in range(layers + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = _resnet(net, f"up_blocks.{i}.resnets.{j}", h, temb, groups,
                        eps)
            if attn:
                h = _transformer(net, f"up_blocks.{i}.attentions.{j}", h,
                                 ctx, heads[::-1][i], depth[::-1][i], lp,
                                 groups)
        if i < n - 1:
            h = net.conv(f"up_blocks.{i}.upsamplers.0.conv",
                         F.interpolate(h, scale_factor=2.0, mode="nearest"))
    h = F.silu(net.group_norm("conv_norm_out", h, groups, eps))
    return net.conv("conv_out", h)


# ------------------------------------------------------------------- VAE


def vae_decode(net: Net, v: dict, z):
    """NCHW latents (unscaled) -> images in [-1, 1]."""
    g, eps = v.get("norm_num_groups", 32), 1e-6
    n = len(v["block_out_channels"])
    layers = v.get("layers_per_block", 2)
    if v.get("use_post_quant_conv", True):
        z = net.conv("post_quant_conv", z)
    h = net.conv("decoder.conv_in", z)

    def attn(key, x):
        b, c, hh, ww = x.shape
        t = net.group_norm(f"{key}.group_norm", x, g, eps).flatten(2)
        t = t.transpose(1, 2)
        o = net.attention(net.linear(f"{key}.to_q", t),
                          net.linear(f"{key}.to_k", t),
                          net.linear(f"{key}.to_v", t), 1)
        o = net.linear(f"{key}.to_out.0", o)
        return x + o.transpose(1, 2).reshape(b, c, hh, ww)

    h = _resnet(net, "decoder.mid_block.resnets.0", h, None, g, eps)
    h = attn("decoder.mid_block.attentions.0", h)
    h = _resnet(net, "decoder.mid_block.resnets.1", h, None, g, eps)
    for i in range(n):
        for j in range(layers + 1):
            h = _resnet(net, f"decoder.up_blocks.{i}.resnets.{j}", h, None, g,
                        eps)
        if i < n - 1:
            h = net.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                         F.interpolate(h, scale_factor=2.0, mode="nearest"))
    h = F.silu(net.group_norm("decoder.conv_norm_out", h, g, eps))
    return net.conv("decoder.conv_out", h)


# --------------------------------------------------------------- request


def _part(state: dict, name: str) -> dict:
    pre = name + "."
    return {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}


class Reference:
    """The plain pipeline of one configuration over the benchmark's
    weights (``state``: {"unet.<key>": tensor, "vae.<key>": ...,
    "text_encoder.<key>": ...})."""

    def __init__(self, config: dict, state: dict, quant=None):
        self.config = config
        self.towers = sorted((k for k in config
                              if k.startswith("text_encoder")),
                             key=lambda k: (len(k), k))
        self.nets = {name: Net(_part(state, name), quant)
                     for name in ["unet", "vae", *self.towers]}
        self.clip_layer = int(config["serving"]["clip_layer"])

    def encode(self, texts: list[str], device):
        ids = torch.tensor([token_ids(t) for t in texts], device=device)
        ctxs, pooled = [], None
        for name in self.towers:
            c, pooled = clip_forward(self.nets[name], self.config[name], ids,
                                     self.clip_layer)
            ctxs.append(c)
        return torch.cat(ctxs, dim=-1), pooled

    @torch.no_grad()
    def generate(self, requests: list[dict], device) -> np.ndarray:
        """uint8 [N, H, W, 3] for requests {"prompt", "negative_prompt",
        "seed", "height", "width", "steps", "cfg_scale"} of one size."""
        u, sch = self.config["unet"], self.config["scheduler"]
        r0 = requests[0]
        h, w = r0["height"] // 8, r0["width"] // 8
        n = len(requests)
        ctx, pooled = self.encode(
            [r["negative_prompt"] for r in requests] +
            [r["prompt"] for r in requests], device)
        added = None
        if u.get("addition_embed_type") == "text_time":
            ids = [float(r0["height"]), float(r0["width"]), 0.0, 0.0,
                   float(r0["height"]), float(r0["width"])]
            added = {"text_embeds": pooled,
                     "time_ids": torch.tensor([ids] * (2 * n),
                                              device=device)}
        scale = torch.tensor([r["cfg_scale"] for r in requests],
                             device=device).reshape(-1, 1, 1, 1)
        sig = sigmas(sch, r0["steps"])
        x = torch.from_numpy(np.stack([
            initial_noise(r["seed"], (h, w, u["out_channels"]))
            for r in requests])).to(device).permute(0, 3, 1, 2)
        x = x * float(sig[0])
        x0_prev = torch.zeros_like(x)
        for i in range(len(sig) - 1):
            s, s_next = float(sig[i]), float(sig[i + 1])
            t = torch.full((2 * n,), sigma_to_t(sch, s), device=device)
            xin = x / math.sqrt(s * s + 1.0)
            e = unet_forward(self.nets["unet"], u, torch.cat([xin, xin]), t,
                             ctx, added)
            e_u, e_c = e.chunk(2)
            x0 = x - (e_u + scale * (e_c - e_u)) * s
            if s_next <= 0:
                x = x0
            else:
                lam, lam_next = -math.log(s), -math.log(s_next)
                hstep = lam_next - lam
                if i > 0:
                    r = (lam + math.log(float(sig[i - 1]))) / hstep
                    d = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * x0_prev
                else:
                    d = x0
                x = (s_next / s) * x - math.expm1(-hstep) * d
            x0_prev = x0
        v = self.config["vae"]
        img = vae_decode(self.nets["vae"], v,
                         x / v.get("scaling_factor", 0.18215))
        img = (img * 0.5 + 0.5).clamp(0.0, 1.0)
        img = (img * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
        return img.permute(0, 2, 3, 1).cpu().numpy()


def fp8_quant(t):
    """Round a tensor to float8 e4m3 under a per-tensor scale (its largest
    magnitude onto 448), back in its own dtype: the control's precision."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    s = 448.0 / amax
    return ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)
