#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gyre_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # env, build, then only the batch-1
                                       # profile (phase_profile)

Phases, each printing one JSON object per line:

  1. env       card name and power limit (nvidia-smi), torch, CUDA and
               Pillow versions
  2. build     nvcc builds every kernel of the path from csrc/ (seconds)
  3. kernels   each hand-written kernel against its plain PyTorch version
               at every SD1.5 main-path shape, called through the entry
               the models call, in their layout (attention() on [B,T,H,D]
               projections, NHWC convs): max abs error / max |plain|
               within a stated bound; median times of kernel, plain version
               and one library call (SDPA, cuDNN conv, var_mean); the
               bound; launches per batch-1 call. K2a also at the batch-8
               call's shapes (its slabs and cluster size depend on B);
               K1, K2a and K2b also at every other shape of the modes
               phase (the VAE encoder, the hires fix's UNet at 128..16
               and 72..9, the VAE at 1024x1024 and in a tiled decode's
               tile), with no launches in the per-call sums and summed
               on a "mode_shapes" line apart from the kernels line; and
               at every shape the ControlNet runs at one row (hint
               priority "hint": the guided CFG half alone) that no other
               row has, summed on a "controlnet_shapes" line; and at
               every shape of the sd2 and sdxl phases' model calls that
               no other row has (walked from the configs' spec trees,
               _c5_calls: K1 at d = 64, the refiner's 384..3072
               channels), summed on a "c5_shapes" line
  4. pipeline  UnifiedPipeline on full-width SD1.5 (random weights from a
               seed): 512x512, 20 steps k_dpmpp_2m, CFG 7.5 (parallel),
               bf16, chunk_steps=10 with a stop_event, uint8 on the device.
               Launch counts of one batch-1 call, batch-1 p50 of 10 calls
               with each call's host numbers (time to queue its work,
               the queuing thread's CPU time and preemptions), batch-8
               images/s, peak memory and what phase 3 left allocated
  5. samplers  every sampler function of the port (15, behind 20 names)
               on the same SD1.5 engine as phase 4, 20 steps, batch 1,
               each with its model calls counted (a wrapper around the
               denoiser) and the kernels' launches checked against them
               (K1 32 x calls + 1, K2a and K2b 44 x calls + 28), finite
               latents, a non-constant image, and its 10-step-chunked run
               equal to its one run in every bit; the knobs (brownian
               noise on k_dpmpp_sde, churn 0.5 on k_heun, eta 0.5 on
               ddim) the same way; batch-8 images/s of k_euler_ancestral
               (per-step noise) beside k_dpmpp_2m; then one Generate
               over gRPC per proto sampler enum (19, 10 steps) answering
               a PNG, and ListEngines listing 19 samplers
  5b. modes    every generation mode on the same SD1.5 request, batch 1
               (MODE_CASES): img2img at strength 0.6 (12 of 20 steps),
               4-channel inpaint (shaped fill, outmask composite),
               inpaint9 and depth2img (9- and 5-channel UNets at SD1.5
               width, random from seed 0), graft (inpaint9 root, SD1.5
               top), the hires fix at 1024x1024 (hi latents 128, lo 72),
               seamless tiling, and the tiled VAE decode of 192x192
               latents (9 tiles); each with its UNet calls, VAE encodes
               and decodes counted and its launches against the
               prediction and the launch rule, finite latents, a
               non-constant image, wall seconds; inpaint's kept pixels
               equal to the init image; img2img, inpaint and graft equal
               to their 10-step-chunked runs in every bit
  5c. adapters LoRA (kohya, rank 8, over every target the resolver knows,
               UNet and text tower), LoHa, LoKr, a full diff and a TI of
               2 vectors, made with numpy from a seed, folded into
               adapted views by the manager (the server as main builds
               it): each view's image differs from the base's, its folded
               leaves equal a host f32 fold rounded to bf16 in every bit,
               its request launches 641 / 908 / 908, and the bytes it
               adds and the seconds its fold holds the dispatcher are
               printed; the base engine's tensors are unchanged in every
               bit; a plain request sent while a new LoRA's deltas are
               rebuilt is not held for them. Over gRPC: the LoRA as the lora field, as
               raw bytes, uploaded with cache_control and then sent as
               its cache_id, and as a url under --local_resource, the TI
               with token_overrides, each within 1 level of the
               in-process image; two distinct LoRAs without a uuid give
               two images; a base and a LoRA request queued together run
               as two batches (two base requests merge)
  5d. hints    ControlNets (random, with random zero convs) and a full T2I
               adapter on SD1.5 at 512x512, 20 steps, batch 1: a
               ControlNet at each priority, two ControlNets, ControlNet
               + T2I, T2I at balanced and hint, a masked ControlNet
               (HINT_CASES), each with exact launches (a ControlNet adds
               14 K1 and 20 K2a/K2b a UNet call), an image that differs
               from the no-hint image, and its wall seconds (median of
               5 rounds over the plain request and every case, in
               order and reversed by turns) beside the plain request's;
               a zero mask and a
               zero-initialised ControlNet give the no-hint image in
               every bit; then the server with a hintset entry naming
               the ControlNet saved as a checkpoint: a hint image of
               384x640 (rescaled, lanczos3) at each priority over gRPC,
               within 1 level of the in-process image
  5e. sd2      an EngineManager engine on the sd21 preset (OpenCLIP-H,
               linear projections, v-prediction; random, seed 0, bf16):
               768x768, 20 steps k_dpmpp_2m, CFG 7.5, batch 1,
               chunk_steps=10; then img2img of its image at strength 0.6;
               each with its UNet calls, encodes and decodes counted and
               its launches equal to those derived from the config (K1 32,
               K2a/K2b 44 a UNet call, a decode 1 / 28, an encode 1 / 20),
               finite latents and float image, a non-constant image of
               768x768; then a Generate over gRPC with no size, answering
               768x768 (the engine's natural size)
  5f. sdxl     SDXL base and refiner engines (presets sdxl and
               sdxl-refiner, random, seed 0, bf16) in one EngineManager:
               the base at 1024x1024 as in 5e (K1 140, K2a/K2b 34 a UNet
               call), again with only its size time ids changed (the
               image must change: the pooled text and time ids reach the
               UNet), the refiner's img2img of its image at strength 0.34
               (K1 88, K2a/K2b 44 a UNet call, plus an encode), each
               checked as in 5e; a ChainGenerate base -> refiner (start
               0.34) -> RETURN over gRPC, one 1024x1024 image, its
               launches those of the two stages; the load seconds, each
               model's weight bytes, the phase's peak memory and
               suggest_max_batch at 1024x1024; both engines freed after
  6. serve     EngineManager + the coalescing dispatcher under concurrent
               requests, then two Generate calls over gRPC
  7. http      the server as main builds it (server.serve: the gRPC
               server behind its access-token interceptor, with the
               dashboard, and the HTTP router) on the sd15 random preset
               (seed 0, bf16), at the request of phase 4 with explicit
               seeds: REST text-to-image as JSON and as PNG (the PNG one's
               launches must be 641 / 908 / 908), an AsyncGenerate polled
               with AsyncResult against a synchronous Generate of the same
               seed (within 1 uint8 level) and an AsyncCancel,
               ChainGenerate with two RETURN stages, Generate over gRPC-Web
               (the port's grpc_web_client), the accept list "image/webp,
               image/png" (a WebP, or UNIMPLEMENTED where Pillow is
               missing), and requests without the token refused
               (UNAUTHENTICATED over gRPC, 401 and 403 over HTTP); REST
               image-to-image and image-to-image/masking (the kept pixels
               equal to the init image's), a ChainGenerate whose PASS
               stage feeds its PNG to the next stage as its init image,
               and ListEngines with a 9-channel inpainting engine beside
               SD1.5, both ready; one line per route with its wall seconds
               and bytes
  8. weights   full-width SD1.5 from disk: a random ModelSet saved as a
               diffusers checkpoint (f32 safetensors), served through an
               engines.yaml in the DSL (an !include, a template with
               params) by server.build_manager and the WeightResolver:
               load seconds and status (weights "real"), prewarm (state
               "done"), one batch-1 request on the loaded engine against
               the in-memory ModelSet (within 1 uint8 level; launches
               641 / 908 / 908), one Generate over gRPC, suggest_max_batch

After each phase from 5 on it prints what the phase left allocated on the
card. At the end it prints the sums of the mode, ControlNet and C5 rows,
the "c5_paths" line (each sd2/sdxl request's launches and the sums over
them of phase 3's kernel, plain, library and bound times), then, before
the last line, the kernels table as one JSON object; the last line is
{"ok": true, "device": {...}}. Any failed check raises and the script exits
non-zero; without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import functools
import gc
import importlib.metadata
import json
import subprocess
import sys
import threading
import time

# bf16 bound for kernel vs plain, as max abs error over max |plain|: one
# bf16 rounding is <= 2^-9 (0.2%) relative, the outputs are rounded once
# more, and kernel and plain round the inputs of the second product (P in
# attention, the activation in the conv) at different points, one bf16 ulp
# (0.4%) each; 2e-2 is ~5x over that compounded rounding, while an indexing
# or masking fault gives errors of order 1.
BF16_BOUND = 2e-2
# K2a's a, b are f32 statistics on both sides; only summation order differs
F32_STATS_BOUND = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


@functools.cache
def _side_stream():
    """One warm-up stream for every _timed call: cuBLAS keeps a workspace
    for each stream it has run on, so a new stream per call would leave
    workspaces allocated into the pipeline phase's peak memory."""
    import torch

    return torch.cuda.Stream()


def _timed(fn, iters: int = 10, reps: int = 10) -> float:
    """Milliseconds of one fn() on the card: ``reps`` calls of fn are
    captured in a CUDA graph, and the median over ``iters`` replays (CUDA
    events) is divided by ``reps``. A replay runs the captured work back
    to back with no host in between, so this is device time, as the bound
    is, and not the host time of a launch from Python (tens of
    microseconds, more than many of these kernels take)."""
    import torch

    side = _side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm-up off the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    times.sort()
    return times[len(times) // 2]


def _errors(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    out, ref = out.float(), ref.float()
    if not bool(out.isfinite().all()):
        return float("inf"), float("inf")
    err = float((out - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-12)


# ------------------------------------------------------------------ phases


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    try:
        pillow = importlib.metadata.version("pillow")
    except importlib.metadata.PackageNotFoundError:
        pillow = None                  # WebP answers are then UNIMPLEMENTED
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "pillow": pillow,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build():
    from gyre_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build()
    for name in paths:
        _build.library(name)
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".so.log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.split("ptxas info    : ", 1)[-1] for ln in lines
                       if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas})


# launches of each kernel in one batch-1 call of the main path: the UNet
# runs once per step (20 steps of DPM++ 2M, parallel CFG: 2 rows) with 16
# transformers x 2 attentions and 22 resnets x 2 fused convs; the VAE
# decoder adds 1 attention and 14 resnets x 2 fused convs. CLIP's causal
# attention stays on the plain path. K2a runs once per K2b.
STEPS = 20
EXPECTED_LAUNCHES = {"flash_attention": 32 * STEPS + 1,
                     "gn_stats": 44 * STEPS + 28,
                     "gn_silu_conv3x3": 44 * STEPS + 28}

# K1 at every main-path shape of a batch-1 call: (name, B, H, Tq, Tk, d,
# launches per call). The UNet has 5 transformers at each of the 64/32/16
# levels (2 down, 3 up) and 1 at 8 (mid), each a self and a cross (Tk=77)
# attention; the VAE's mid block has one single-head d=512 attention.
ATTN_SHAPES = [
    ("unet_self_64", 2, 8, 4096, 4096, 40, 5 * STEPS),
    ("unet_self_32", 2, 8, 1024, 1024, 80, 5 * STEPS),
    ("unet_self_16", 2, 8, 256, 256, 160, 5 * STEPS),
    ("unet_self_8", 2, 8, 64, 64, 160, 1 * STEPS),
    ("unet_cross_64", 2, 8, 4096, 77, 40, 5 * STEPS),
    ("unet_cross_32", 2, 8, 1024, 77, 80, 5 * STEPS),
    ("unet_cross_16", 2, 8, 256, 77, 160, 5 * STEPS),
    ("unet_cross_8", 2, 8, 64, 77, 160, 1 * STEPS),
    ("vae_mid", 1, 1, 4096, 4096, 512, 1),
]
# K1 at every shape of the modes phase that the batch-1 call does not run,
# kept apart from ATTN_SHAPES (no launches of a batch-1 call, and not in
# the kernels line): the hires fix's UNet at 1024x1024, hi latents 128..16
# and lo 72..9 (self T = 16384/4096/1024 and 5184/1296/324/81, cross
# against 77 tokens; its hi mid level is unet_*_16's shape), the VAE
# decoder's mid block at 1024x1024 and in a tiled decode's 96x96-latent
# tile. The VAE encoder's mid block is vae_mid's shape.
MODE_ATTN_SHAPES = [
    (f"hires_{kind}_{t}", 2, 8, t, t if kind == "self" else 77, d)
    for kind in ("self", "cross")
    for t, d in ((16384, 40), (4096, 80), (1024, 160),
                 (5184, 40), (1296, 80), (324, 160), (81, 160))] + [
    ("vae_mid_1024", 1, 1, 16384, 16384, 512),
    ("vae_mid_tile96", 1, 1, 9216, 9216, 512),
]
# K2a + K2b at every distinct GN -> SiLU -> conv3x3 shape of a batch-1
# call: (name, B, H=W, C, Co, eps, launches per call). A resnet is conv1
# C -> Co and conv2 Co -> Co. UNet (B=2): 2 resnets per down level, 2 in
# the mid block, 3 per up level whose conv1 takes the skip concatenation
# (e.g. 8x8: 1280+1280 = 2560 in; 64x64: 640+320 = 960, 320+320 = 640).
# VAE decoder (B=1): 2 mid resnets and 3 per up level at 64/128/256/512.
CONV_SHAPES = [
    ("unet_64_320_320", 2, 64, 320, 320, 1e-5, 7 * STEPS),
    ("unet_64_960_320", 2, 64, 960, 320, 1e-5, 1 * STEPS),
    ("unet_64_640_320", 2, 64, 640, 320, 1e-5, 2 * STEPS),
    ("unet_32_320_640", 2, 32, 320, 640, 1e-5, 1 * STEPS),
    ("unet_32_640_640", 2, 32, 640, 640, 1e-5, 6 * STEPS),
    ("unet_32_1920_640", 2, 32, 1920, 640, 1e-5, 1 * STEPS),
    ("unet_32_1280_640", 2, 32, 1280, 640, 1e-5, 1 * STEPS),
    ("unet_32_960_640", 2, 32, 960, 640, 1e-5, 1 * STEPS),
    ("unet_16_640_1280", 2, 16, 640, 1280, 1e-5, 1 * STEPS),
    ("unet_16_1280_1280", 2, 16, 1280, 1280, 1e-5, 6 * STEPS),
    ("unet_16_2560_1280", 2, 16, 2560, 1280, 1e-5, 2 * STEPS),
    ("unet_16_1920_1280", 2, 16, 1920, 1280, 1e-5, 1 * STEPS),
    ("unet_8_1280_1280", 2, 8, 1280, 1280, 1e-5, 11 * STEPS),
    ("unet_8_2560_1280", 2, 8, 2560, 1280, 1e-5, 3 * STEPS),
    ("vae_64_512_512", 1, 64, 512, 512, 1e-6, 10),
    ("vae_128_512_512", 1, 128, 512, 512, 1e-6, 6),
    ("vae_256_512_256", 1, 256, 512, 256, 1e-6, 1),
    ("vae_256_256_256", 1, 256, 256, 256, 1e-6, 5),
    ("vae_512_256_128", 1, 512, 256, 128, 1e-6, 1),
    ("vae_512_128_128", 1, 512, 128, 128, 1e-6, 5),
]


def _mode_conv_shapes():
    """K2a + K2b at every distinct GN -> SiLU -> conv3x3 shape of the modes
    phase that the batch-1 call does not run, kept apart from CONV_SHAPES
    (no launches of a batch-1 call, and not in the kernels line): (name,
    B, H=W, C, Co, eps). Each is a batch-1 shape at another level size:
    the hires fix's UNet at 1024x1024 (the 64/32/16/8 levels at 128/64/
    32/16 hi and 72/36/18/9 lo), the VAE decoder of a tiled decode's
    96x96-latent tile (64/128/256/512 at 96/192/384/768) and at 1024x1024
    (at 128/256/512/1024); and the VAE encoder's two channel pairs at 512x
    512 that the decoder lacks (its others are decoder shapes). A shape
    that a batch-1 row already checks is left out."""
    seen = {(b, hw, c, co, eps) for _, b, hw, c, co, eps, _ in CONV_SHAPES}
    out = []
    for name, b, hw, c, co, eps, _ in CONV_SHAPES:
        model, pairs = name.split("_")[0], ()
        if model == "unet":
            pairs = (("hires", hw * 2), ("hires", hw * 9 // 8))
        elif model == "vae":
            pairs = (("tile96", hw * 3 // 2), ("vae1024", hw * 2))
        for prefix, size in pairs:
            if (b, size, c, co, eps) not in seen:
                seen.add((b, size, c, co, eps))
                out.append((f"{prefix}_{size}_{c}_{co}", b, size, c, co,
                            eps))
    return out + [("venc_256_128_256", 1, 256, 128, 256, 1e-6),
                  ("venc_128_256_512", 1, 128, 256, 512, 1e-6)]


MODE_CONV_SHAPES = _mode_conv_shapes()


def _controlnet_shapes():
    """(K1 rows, K2a + K2b rows) at every distinct shape that SD1.5's
    ControlNet runs at 512x512 and phases 3's other rows lack: its down
    path (a level's resnets and transformers, then the mid block's) at 2
    rows (both CFG halves: the UNet's own shapes) and at 1 row (cfg_only,
    the guided half alone). Walked from the port's ControlNet spec tree;
    K1 rows (name, B, H, Tq, Tk, d), conv rows (name, B, H=W, C, Co,
    eps)."""
    from gyre_tpu_torch.models import configs, controlnet

    cfg = configs.SD15.unet
    specs = controlnet.param_specs(cfg)
    seen_conv = {r[1:6] for r in CONV_SHAPES + MODE_CONV_SHAPES}
    seen_attn = {r[1:6] for r in ATTN_SHAPES + MODE_ATTN_SHAPES}
    levels = [(lvl, 64 >> lvl, blk["resnets"], blk["attns"])
              for lvl, blk in enumerate(specs["down"])]
    mid = specs["mid"]
    levels.append((cfg.levels - 1, 64 >> (cfg.levels - 1),
                   [mid["res1"], mid["res2"]], [mid["attn"]]))
    attns, convs = [], []
    for b in (2, 1):
        for lvl, hw, resnets, transformers in levels:
            for res in resnets:
                _, _, c, co = res["conv1"]["w"].shape
                for dims in ((b, hw, c, co, 1e-5), (b, hw, co, co, 1e-5)):
                    if dims not in seen_conv:
                        seen_conv.add(dims)
                        convs.append((f"cn_b{b}_{hw}_{dims[2]}_{dims[3]}",
                                      *dims))
            for tr in transformers:
                heads = cfg.num_heads[lvl]
                d = tr["proj_in"]["w"].shape[0] // heads
                for kind, tk in (("self", hw * hw), ("cross", 77)):
                    dims = (b, heads, hw * hw, tk, d)
                    if dims not in seen_attn:
                        seen_attn.add(dims)
                        attns.append((f"cn_b{b}_{kind}_{hw * hw}", *dims))
    return attns, convs
# ------------------------------------------------- model calls by config


def _unet_call_shapes(cfg, size: int, b: int = 2):
    """(K1 launches, K2 launches) of one UNet call at latent size
    ``size``², walked from the port's spec tree of ``cfg``: one entry a
    launch, K1 as (B, H, Tq, Tk, d), K2a/K2b as (B, H=W, C, Co, eps). A
    transformer block is a self and a cross (77 tokens) attention, a
    resnet its two fused convs."""
    from gyre_tpu_torch.models import unet

    specs = unet.param_specs(cfg)
    attns, convs = [], []

    def level(resnets, transformers, hw, heads):
        for i, res in enumerate(resnets):
            _, _, c, co = res["conv1"]["w"].shape
            convs.extend([(b, hw, c, co, 1e-5), (b, hw, co, co, 1e-5)])
            if transformers:
                tr = transformers[i]
                d = tr["proj_in"]["w"].shape[0] // heads
                for _ in tr["blocks"]:
                    attns.extend([(b, heads, hw * hw, hw * hw, d),
                                  (b, heads, hw * hw, 77, d)])

    last = cfg.levels - 1
    for lvl, blk in enumerate(specs["down"]):
        level(blk["resnets"], blk["attns"], size >> lvl, cfg.num_heads[lvl])
    mid = specs["mid"]
    level([mid["res1"]], [mid["attn"]] if "attn" in mid else [],
          size >> last, cfg.num_heads[last])
    level([mid["res2"]], [], size >> last, cfg.num_heads[last])
    for i, blk in enumerate(specs["up"]):
        level(blk["resnets"], blk["attns"], size >> (last - i),
              cfg.num_heads[last - i])
    return attns, convs


def _vae_call_shapes(cfg, size: int, part: str):
    """(K1 launches, K2 launches) of one VAE call at batch 1, as
    _unet_call_shapes: ``part`` "decoder" at latent size ``size``² or
    "encoder" at image size ``size``²; the mid block's attention is one
    head of d = C."""
    from gyre_tpu_torch.models import vae

    specs = vae.param_specs(cfg)[part]
    n = len(cfg.block_out_channels)
    attns, convs = [], []

    def resnets(blocks, hw):
        for res in blocks:
            _, _, c, co = res["conv1"]["w"].shape
            convs.extend([(1, hw, c, co, 1e-6), (1, hw, co, co, 1e-6)])

    def mid(hw):
        c = specs["mid"]["attn"]["q"]["w"].shape[0]
        resnets([specs["mid"]["res1"], specs["mid"]["res2"]], hw)
        attns.append((1, 1, hw * hw, hw * hw, c))

    if part == "encoder":
        for lvl, blk in enumerate(specs["down"]):
            resnets(blk["resnets"], size >> lvl)
        mid(size >> (n - 1))
    else:
        mid(size)
        for i, blk in enumerate(specs["up"]):
            resnets(blk["resnets"], size << i)
    return attns, convs


def _launches(parts):
    """Expected launches of a request of _c5_paths: parts [(count,
    _c5_calls name)]."""
    calls = _c5_calls()
    k1 = sum(n * len(calls[c][0]) for n, c in parts)
    k2 = sum(n * len(calls[c][1]) for n, c in parts)
    return {"flash_attention": k1, "gn_stats": k2, "gn_silu_conv3x3": k2}


def _c5_calls():
    """The model calls of the sd2 and sdxl phases, by name: (K1, K2)
    shapes of one call. SD2 at 768² (96 latents) and its img2img's
    encode; SDXL base and refiner at 1024² (128 latents), the refiner's
    img2img encode; parallel CFG: the UNets at 2 rows."""
    from gyre_tpu_torch.models import configs

    sd2, xl, ref = (configs.PRESETS[p]
                    for p in ("sd21", "sdxl", "sdxl-refiner"))
    return {
        "sd2_unet": _unet_call_shapes(sd2.unet, 96),
        "sd2_decode": _vae_call_shapes(sd2.vae, 96, "decoder"),
        "sd2_encode": _vae_call_shapes(sd2.vae, 768, "encoder"),
        "sdxl_unet": _unet_call_shapes(xl.unet, 128),
        "refiner_unet": _unet_call_shapes(ref.unet, 128),
        "sdxl_decode": _vae_call_shapes(xl.vae, 128, "decoder"),
        "sdxl_encode": _vae_call_shapes(xl.vae, 1024, "encoder"),
    }


def _strength_steps(strength: float) -> int:
    """UNet calls of a k_dpmpp_2m img2img at ``strength`` (one a step of
    the truncated ramp)."""
    from gyre_tpu_torch.pipeline import schedule as sched

    return len(sched.build_sigmas(sched.scaled_linear_schedule(), STEPS,
                                  strength=strength)) - 1


def _c5_paths():
    """The requests of the sd2 and sdxl phases as model calls: {name:
    [(count, _c5_calls name)]}; an img2img at strength 0.6 runs the last
    12 steps of the ramp, at 0.34 the last 7."""
    return {"sd2_768": [(STEPS, "sd2_unet"), (1, "sd2_decode")],
            "sd2_img2img_768": [(_strength_steps(0.6), "sd2_unet"),
                                (1, "sd2_encode"), (1, "sd2_decode")],
            "sdxl_1024": [(STEPS, "sdxl_unet"), (1, "sdxl_decode")],
            "refiner_img2img_1024": [(_strength_steps(0.34), "refiner_unet"),
                                     (1, "sdxl_encode"),
                                     (1, "sdxl_decode")]}


def _path_sums(kernels, parts):
    """Per kernel, a request's launches and the sums over its launches of
    phase 3's median times (kernel, plain, library) and bounds, each
    launch priced at its shape's row, whichever set the row is in."""
    calls = _c5_calls()
    rows = {(name, tuple(r["dims"])): r for name, rs in kernels.items()
            for r in rs}
    out = []
    for name, _, _ in KERNEL_TABLE:
        sums = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"),
                             0.0)
        launches = 0
        for count, call in parts:
            attns, convs = calls[call]
            for dims in attns if name == "flash_attention" else convs:
                if name != "flash_attention":      # (B, H=W, C, Co, eps)
                    b, hw, c, co, _ = dims
                    dims = (b, hw, hw, c) + ((co,) if name ==
                                              "gn_silu_conv3x3" else ())
                r = rows[(name, dims)]
                launches += count
                for k in sums:
                    sums[k] += count * r[k]
        out.append({"name": name, "launches": launches, **sums})
    return out


def _c5_shapes():
    """(K1 rows, K2a + K2b rows) at every distinct shape of _c5_calls that
    phase 3's other rows lack: K1 rows (name, B, H, Tq, Tk, d), conv rows
    (name, B, H=W, C, Co, eps)."""
    cn_attn, cn_conv = _controlnet_shapes()
    seen_attn = {r[1:6] for r in ATTN_SHAPES + MODE_ATTN_SHAPES + cn_attn}
    seen_conv = {r[1:6] for r in CONV_SHAPES + MODE_CONV_SHAPES + cn_conv}
    attns, convs = [], []
    for call, (a, c) in _c5_calls().items():
        model = call.split("_")[0]
        for dims in a:
            if dims not in seen_attn:
                seen_attn.add(dims)
                kind = "cross" if dims[3] == 77 else "self"
                attns.append((f"{model}_{kind}_{dims[2]}_d{dims[4]}", *dims))
        for dims in c:
            if dims not in seen_conv:
                seen_conv.add(dims)
                convs.append((f"{call}_{dims[1]}_{dims[2]}_{dims[3]}",
                              *dims))
    return attns, convs


# K2a alone at two shapes of a batch-8 call, where its launch differs from
# batch 1's: (name, B, H=W, C, eps, launches per batch-8 call). The UNet
# runs 16 rows (8 images x 2 CFG rows), the VAE 8.
GN_BATCH8_SHAPES = [
    ("b8_unet_64_320", 16, 64, 320, 1e-5, 7 * STEPS),
    ("b8_vae_512_128", 8, 512, 128, 1e-6, 5),
]

# Bounds: the least time the card could take for a kernel's work, the
# larger of its operations over the peak rate for their type and its bytes
# (each input read once, each output written once) over the memory rate.
# H100 SXM peaks (NVIDIA's data sheet, 700 W): 989e12 bf16 tensor-core
# FLOP/s, 67e12 f32 FLOP/s outside the tensor cores, 3.35e12 bytes/s.
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def _bound(ops: float, rate: float, nbytes: float) -> tuple[float, str]:
    """(bound in ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / rate, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attn_bound(b, h, tq, tk, d):
    # K1: QK^T and PV, 2 FLOP per multiply-add: 4*B*H*Tq*Tk*d; bytes: bf16
    # q and o [B,H,Tq,d], k and v [B,H,Tk,d]: 2*B*H*d*(2*Tq + 2*Tk)
    return _bound(4 * b * h * tq * tk * d, PEAK_BF16_TC,
                  2 * b * h * d * (2 * tq + 2 * tk))


def conv_bound(m, c, co):
    # K2b: implicit GEMM M x Co x 9C: 2*M*Co*9*C FLOP; bytes: bf16 x [M,C],
    # weight [9C,Co] and out [M,Co]: 2*(M*C + 9*C*Co + M*Co)
    return _bound(2 * m * co * 9 * c, PEAK_BF16_TC,
                  2 * (m * c + 9 * c * co + m * co))


def stats_bound(b, m, c):
    # K2a: ~3 f32 operations per element (shift, sum, sum of squares) off
    # the tensor cores; bytes: bf16 x [M,C] read, f32 a, b [B,C] written
    return _bound(3 * m * c, PEAK_F32, 2 * m * c + 2 * 4 * b * c)


def _row(name, shape, launches, errors, bound_rel, fn, plain, library,
         bound):
    """One phase-3 row: the kernel's (max abs, relative) errors against its
    plain version, checked against ``bound_rel``; median times of kernel,
    plain version and library call; the bound; launches per batch-1
    call."""
    abs_err, err = errors
    row = {"shape": name, "dims": shape, "launches_per_call": launches,
           "max_abs_err": abs_err, "max_abs_err_rel": err,
           "bound": bound_rel, "ms": _timed(fn), "plain_ms": _timed(plain),
           "library_ms": _timed(library), "bound_ms": bound[0],
           "bound_by": bound[1]}
    return row, err <= bound_rel


def phase_kernels():
    """Each kernel against its plain version on the same inputs, at every
    main-path shape, with its bound and a library call's time."""
    import torch
    import torch.nn.functional as F

    from gyre_tpu_torch.ops import attention as A
    from gyre_tpu_torch.ops import fused_norm_conv as FC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"flash_attention": [], "gn_stats": [], "gn_silu_conv3x3": []}
    failed = []
    bf = torch.bfloat16

    def rand(*shape, dtype=bf, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale +
                shift).to(dtype)

    def record(kernel, row_ok, **extra):
        row, ok = row_ok
        row.update(extra)
        emit({"phase": "kernels", "kernel": kernel, **row})
        results[kernel].append(row)
        if not ok:
            failed.append(f"{kernel} {row['shape']}: error "
                          f"{row['max_abs_err_rel']}")

    def record_stats(name, b, hw, c, eps, launches, **extra):
        """K2a's row on a fresh x [b,hw,hw,c] and GroupNorm scale and bias;
        returns those inputs, K2a's (a, b) and the plain version's."""
        # per-channel offsets exercise the statistics' cancellation
        x = (torch.randn((b, hw, hw, c), generator=gen, device=dev) +
             torch.randn((c,), generator=gen, device=dev) * 2.0).to(bf)
        gs = rand(c, dtype=torch.float32, scale=0.1, shift=1.0)
        gb = rand(c, dtype=torch.float32, scale=0.1)
        a, bb = FC.gn_affine(x, gs, gb, 32, eps)
        a_ref, b_ref = FC.gn_affine_plain(x, gs, gb, 32, eps)
        errs = [_errors(a, a_ref), _errors(bb, b_ref)]
        xg = x.view(b, -1, 32, c // 32)
        record("gn_stats", _row(
            name, [b, hw, hw, c], launches, (max(e[0] for e in errs),
                                             max(e[1] for e in errs)),
            F32_STATS_BOUND,
            lambda: FC.gn_affine(x, gs, gb, 32, eps),
            lambda: FC.gn_affine_plain(x, gs, gb, 32, eps),
            lambda: torch.var_mean(xg, dim=(1, 3)),
            stats_bound(b, b * hw * hw, c)), **extra)
        return x, gs, gb, (a, bb), (a_ref, b_ref)

    def attn_row(name, b, h, tq, tk, d, launches, **extra):
        # as the models call K1: attention() on [B,T,H,D] projections, a
        # linear layer's [B,T,H*D] output reshaped (token stride H*D, head
        # stride D); the plain version and SDPA take the [B,H,T,D] views
        q = rand(b, tq, h * d).view(b, tq, h, d)
        k, v = (rand(b, tk, h * d).view(b, tk, h, d) for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        scale = d ** -0.5
        record("flash_attention", _row(
            name, [b, h, tq, tk, d], launches,
            _errors(A.attention(q, k, v, scale=scale),
                    A.attention_plain(qt, kt, vt, scale).transpose(1, 2)),
            BF16_BOUND,
            lambda: A.attention(q, k, v, scale=scale),
            lambda: A.attention_plain(qt, kt, vt, scale),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
            attn_bound(b, h, tq, tk, d)), **extra)
        del q, k, v, qt, kt, vt

    def conv_row(name, b, hw, c, co, eps, launches, **extra):
        dims = [b, hw, hw, c, co]
        m = b * hw * hw
        x, gs, gb, (a, bb), (a_ref, b_ref) = record_stats(
            name, b, hw, c, eps, launches, **extra)
        w = rand(3, 3, c, co, scale=(9 * c) ** -0.5)
        cb = rand(co, dtype=torch.float32, scale=0.1)

        # cuDNN's conv on the activated input, both channels_last
        y = F.silu(x.float() * a_ref[:, None, None] +
                   b_ref[:, None, None]).to(bf).permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cb_bf = cb.to(bf)
        chain = FC.gn_silu_conv3x3(x, gs, gb, w, cb, groups=32, eps=eps)
        chain_ref = FC.gn_silu_conv3x3_plain(x, gs, gb, w, cb, groups=32,
                                             eps=eps)
        record("gn_silu_conv3x3", _row(
            name, dims, launches,
            _errors(FC.affine_silu_conv3x3(x, a_ref, b_ref, w, cb),
                    FC.affine_silu_conv3x3_plain(x, a_ref, b_ref, w, cb)),
            BF16_BOUND,
            lambda: FC.affine_silu_conv3x3(x, a, bb, w, cb),
            lambda: FC.affine_silu_conv3x3_plain(x, a, bb, w, cb),
            lambda: F.conv2d(y, w_cl, cb_bf, padding=1),
            conv_bound(m, c, co)),
            chain_err_rel=_errors(chain, chain_ref)[1],
            chain_ms=_timed(lambda: FC.gn_silu_conv3x3(
                x, gs, gb, w, cb, groups=32, eps=eps)),
            chain_plain_ms=_timed(lambda: FC.gn_silu_conv3x3_plain(
                x, gs, gb, w, cb, groups=32, eps=eps)), **extra)
        if not results["gn_silu_conv3x3"][-1]["chain_err_rel"] <= BF16_BOUND:
            failed.append(f"gn_silu_conv3x3 chain {name}")
        del x, a, bb, a_ref, b_ref, w, y, w_cl, chain, chain_ref

    for shape in ATTN_SHAPES:
        attn_row(*shape)
    for shape in CONV_SHAPES:
        conv_row(*shape)
    # the modes phase's shapes: no launches of a batch-1 call, tagged so
    # that the kernels line leaves them out
    for shape in MODE_ATTN_SHAPES:
        attn_row(*shape, 0, modes=True)
    for shape in MODE_CONV_SHAPES:
        conv_row(*shape, 0, modes=True)
    # the ControlNet's batch-1 shapes (hint priority "hint"), tagged apart
    cn_attn, cn_conv = _controlnet_shapes()
    for shape in cn_attn:
        attn_row(*shape, 0, controlnet=True)
    for shape in cn_conv:
        conv_row(*shape, 0, controlnet=True)
    # the sd2 and sdxl phases' shapes (K1 at d = 64 among them), tagged
    # apart
    c5_attn, c5_conv = _c5_shapes()
    for shape in c5_attn:
        attn_row(*shape, 0, c5=True)
    for shape in c5_conv:
        conv_row(*shape, 0, c5=True)
    for name, b, hw, c, eps, launches in GN_BATCH8_SHAPES:
        # not in a batch-1 call: no launches of its per-call sums
        record_stats(name, b, hw, c, eps, 0,
                     launches_per_batch8_call=launches)
    torch.cuda.synchronize()
    if failed:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(failed))
    return results


def _call(pipe, seeds, kw):
    """One pipeline call: (output, host numbers). ``enqueue_s``: until the
    call returns with its work queued on the card (the path does not wait
    on the card before its end); ``wall_s``: until the card has finished;
    ``cpu_s`` and ``involuntary_switches``: the calling thread's CPU time
    and preemptions while it queued. enqueue ~ wall means the card waited
    on the host; cpu ~ enqueue means the thread ran all that time."""
    import resource

    import torch

    r0 = resource.getrusage(resource.RUSAGE_THREAD)
    t0 = time.perf_counter()
    out = pipe(seeds=list(seeds), **kw)
    t1 = time.perf_counter()
    r1 = resource.getrusage(resource.RUSAGE_THREAD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {"wall_s": wall, "enqueue_s": t1 - t0,
                 "cpu_s": (r1.ru_utime + r1.ru_stime) -
                 (r0.ru_utime + r0.ru_stime),
                 "involuntary_switches": r1.ru_nivcsw - r0.ru_nivcsw}


REQUEST = dict(prompt="a photograph of an astronaut riding a horse",
               negative_prompt="blurry", height=512, width=512, steps=STEPS,
               sampler="k_dpmpp_2m", guidance_scale=7.5)


def phase_pipeline():
    """SD1.5 txt2img through UnifiedPipeline, the serving configuration."""
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.models.modelset import random_preset
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline

    allocated_before = torch.cuda.memory_allocated()  # left by phase 3
    t0 = time.perf_counter()
    ms = random_preset("sd15", seed=0, dtype=torch.bfloat16, device="cuda")
    pipe = UnifiedPipeline(ms, compute_dtype=torch.bfloat16)
    kw = dict(REQUEST, output_dtype="uint8", chunk_steps=10,
              stop_event=threading.Event())

    def run(seeds):
        return _call(pipe, seeds, kw)[0]

    run([0])                                             # warm-up
    setup_s = time.perf_counter() - t0

    _build.reset_launches()
    img, host = _call(pipe, [1], kw)
    calls = [host]
    launches = dict(_build.launches)
    emit({"phase": "pipeline", "check": "launches", "launches": launches,
          "expected": EXPECTED_LAUNCHES})
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches} != "
                             f"{EXPECTED_LAUNCHES}")
    if tuple(img.shape) != (1, 512, 512, 3) or img.dtype != torch.uint8 \
            or img.device.type != "cuda":
        raise AssertionError(f"image {tuple(img.shape)} {img.dtype} on "
                             f"{img.device}")
    if int(img.max()) == int(img.min()):
        raise AssertionError("image is constant")
    for s in range(2, 11):
        calls.append(_call(pipe, [s], kw)[1])
    latencies = [c["wall_s"] for c in calls]
    p50 = sorted(latencies)[len(latencies) // 2]

    latents = pipe(seeds=[5], **dict(kw, output_dtype=None),
                   return_latents=True)
    if tuple(latents.shape) != (1, 64, 64, 4) or \
            not bool(latents.isfinite().all()):
        raise AssertionError("latents before quantisation are not finite")
    lat_std = float(latents.float().std())

    torch.cuda.reset_peak_memory_stats()
    imgs = run(range(8))                                  # warm-up
    if tuple(imgs.shape) != (8, 512, 512, 3):
        raise AssertionError(f"batch-8 images {tuple(imgs.shape)}")
    runs = 2
    t0 = time.perf_counter()
    for i in range(runs):
        run(range(8 * (i + 1), 8 * (i + 2)))
    batch_s = (time.perf_counter() - t0) / runs
    out = {"phase": "pipeline", "setup_s": setup_s,
           "batch1_latencies_s": latencies, "batch1_p50_s": p50,
           "batch1_host": calls,
           "batch8_s": batch_s, "batch8_images_per_s": 8 / batch_s,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "allocated_before_bytes": allocated_before,
           "latent_std": lat_std, "image_mean": float(img.float().mean())}
    emit(out)
    del pipe, ms
    torch.cuda.empty_cache()
    return launches


# the sampler functions, each under one of its names, with its model calls
# for an n-step ramp: one a step; two a step but the last where the update
# takes a second evaluation; PLMS's first-step corrector adds one;
# dpm_adaptive makes two an iteration and a final denoise
SAMPLER_RUNS = [
    ("k_euler", "n"), ("k_euler_ancestral", "n"), ("k_heun", "2n-1"),
    ("k_dpm_2", "2n-1"), ("k_dpm_2_ancestral", "2n-1"), ("k_lms", "n"),
    ("plms", "n+1"), ("k_dpmpp_2s_ancestral", "2n-1"), ("k_dpmpp_2m", "n"),
    ("k_dpmpp_sde", "2n-1"), ("dpmsolverpp_3order", "n"), ("ddim", "n"),
    ("ddpm", "n"), ("dpm_fast", "n"), ("dpm_adaptive", "2k+1"),
]
# the request knobs, each on a sampler that reads it
KNOB_RUNS = [
    ("k_dpmpp_sde", "2n-1", {"noise_type": "brownian"}),
    ("k_heun", "2n-1", {"churn": 0.5}),
    ("ddim", "n", {"eta": 0.5}),
]


def _sampler_run(pipe, sampler, nfe_rule, knobs):
    """One sampler at the phase-4 request, batch 1: (result line, list of
    failed checks). Model calls are counted by a wrapper around the
    pipeline's denoiser, the latents read at the VAE's input."""
    import torch

    from gyre_tpu_torch import _build

    calls, latents = [], []
    make_denoiser, decode = pipe._denoiser, pipe.vae_decode

    def counting_denoiser(*args, **kwargs):
        dn = make_denoiser(*args, **kwargs)

        def counted(x, sigma):
            calls.append(sigma)
            return dn(x, sigma)

        return counted

    def recording_decode(lat):
        latents.append(lat)
        return decode(lat)

    pipe._denoiser, pipe.vae_decode = counting_denoiser, recording_decode
    try:
        kw = dict(REQUEST, sampler=sampler, output_dtype="uint8", **knobs)
        _build.reset_launches()
        img, host = _call(pipe, [1], kw)
        launches = dict(_build.launches)
        nfe = len(calls)
        chunked, chunked_host = _call(
            pipe, [1], dict(kw, chunk_steps=10, stop_event=threading.Event()))
    finally:
        del pipe._denoiser, pipe.vae_decode
    n = STEPS
    iterations = (nfe - 1) // 2
    expect_nfe = {"n": n, "2n-1": 2 * n - 1, "n+1": n + 1,
                  "2k+1": 2 * iterations + 1}[nfe_rule]
    expect = {"flash_attention": 32 * nfe + 1, "gn_stats": 44 * nfe + 28,
              "gn_silu_conv3x3": 44 * nfe + 28}
    lat = latents[0]
    line = {"phase": "samplers", "sampler": sampler, "knobs": knobs,
            "steps": n, "nfe": nfe, "nfe_rule": nfe_rule,
            "launches": launches, "expected_launches": expect,
            "chunked_equal": bool(torch.equal(img, chunked)),
            "latents_finite": bool(lat.isfinite().all()),
            "latent_std": float(lat.float().std()),
            "image_min": int(img.min()), "image_max": int(img.max()),
            "wall_s": host["wall_s"], "chunked_wall_s": chunked_host["wall_s"]}
    if nfe_rule == "2k+1":
        line["iterations"] = iterations
    failed = [f"{sampler} {knobs}: {what}" for what, bad in (
        (f"{nfe} model calls, expected {expect_nfe}", nfe != expect_nfe),
        (f"launches {launches} != {expect}", launches != expect),
        ("10-step chunks differ from one run", not line["chunked_equal"]),
        ("latents not finite", not line["latents_finite"]),
        ("constant image", line["image_min"] == line["image_max"]),
        (f"image {tuple(img.shape)} {img.dtype}",
         tuple(img.shape) != (1, 512, 512, 3) or img.dtype != torch.uint8))
        if bad]
    return line, failed


def phase_samplers():
    """Every sampler function on full-width SD1.5, checked by its model
    calls and launches; the knobs; per-step noise at batch 8; then every
    proto sampler enum over gRPC and ListEngines."""
    import grpc
    import torch

    from gyre_tpu_torch.generated import engines_pb2 as epb
    from gyre_tpu_torch.manager.manager import EngineManager
    from gyre_tpu_torch.server import build_server
    from gyre_tpu_torch.services.generate import pb

    manager = EngineManager(
        [{"id": "sd15", "default": True,
          "model": {"preset": "sd15", "seed": 0}}],
        device="cuda", batch_max=4, gather_ms=0.0)
    try:
        manager.load_engines()
        pipe = manager.pipeline("sd15")
        failed = []
        for sampler, rule, knobs in [(s, r, {}) for s, r in SAMPLER_RUNS] \
                + KNOB_RUNS:
            line, bad = _sampler_run(pipe, sampler, rule, knobs)
            emit(line)
            failed += bad

        # per-step noise at the dispatcher's merged batch: both samplers
        # make 20 model calls, so the gap is what the noise costs
        kw = dict(REQUEST, output_dtype="uint8", chunk_steps=10,
                  stop_event=threading.Event())
        rates = {"k_dpmpp_2m": [], "k_euler_ancestral": []}
        hosts = {name: [] for name in rates}
        for name in rates:                                   # warm-up
            _call(pipe, range(8), dict(kw, sampler=name))
        for i, name in enumerate(["k_dpmpp_2m", "k_euler_ancestral",
                                  "k_euler_ancestral", "k_dpmpp_2m"]):
            _, host = _call(pipe, range(8 * (i + 1), 8 * (i + 2)),
                            dict(kw, sampler=name))
            rates[name].append(8 / host["wall_s"])
            hosts[name].append(host)
        emit({"phase": "samplers", "check": "batch8_noise_cost",
              "images_per_s": rates, "host": hosts})

        server, port = build_server(manager, 0, batch_max=4,
                                    host="localhost")
        try:
            channel = grpc.insecure_channel(f"localhost:{port}")
            call = channel.unary_stream(
                "/gooseai.GenerationService/Generate",
                request_serializer=pb.Request.SerializeToString,
                response_deserializer=pb.Answer.FromString)
            walls = {}
            for enum in pb.DiffusionSampler.values():
                req = _generate_request(400 + enum % 100)
                req.image.transform.diffusion = enum
                req.image.steps = 10
                t0 = time.perf_counter()
                arts = [a for ans in call(req, timeout=600)
                        for a in ans.artifacts
                        if a.type == pb.ARTIFACT_IMAGE]
                walls[pb.DiffusionSampler.Name(enum)] = \
                    time.perf_counter() - t0
                if len(arts) != 1 or arts[0].mime != "image/png" or \
                        not arts[0].binary.startswith(b"\x89PNG\r\n\x1a\n"):
                    failed.append(f"Generate with sampler {enum} returned "
                                  "no PNG")
            listed = channel.unary_unary(
                "/gooseai.EnginesService/ListEngines",
                request_serializer=epb.ListEnginesRequest.SerializeToString,
                response_deserializer=epb.Engines.FromString)(
                    epb.ListEnginesRequest(), timeout=60).engine
            samplers = [s.sampler for s in listed[0].supported_samplers]
            emit({"phase": "samplers", "check": "grpc", "steps": 10,
                  "wall_s": walls, "listed_samplers": len(samplers)})
            if sorted(samplers) != sorted(pb.DiffusionSampler.values()):
                failed.append(f"ListEngines lists {samplers}")
            channel.close()
        finally:
            server.stop(0).wait()
        if failed:
            raise AssertionError("samplers: " + "; ".join(failed))
    finally:
        manager.dispatcher.stop()
        del manager
        torch.cuda.empty_cache()


class _Counted:
    """Counts UNet calls (and whether one ran tiled), VAE encodes and
    decodes while active, the models' functions wrapped, and records
    whether each decode's latents and float image are finite and the image
    not constant. ``run`` resets the kernels' launch counts just before a
    call and reads them just after."""

    def __enter__(self):
        from gyre_tpu_torch.models import unet as unet_mod
        from gyre_tpu_torch.models import vae as vae_mod

        self.mods = unet_mod, vae_mod
        self.saved = unet_mod.apply, vae_mod.encode, vae_mod.decode
        apply, encode, decode = self.saved
        self.images = []
        self.reset()

        def counted_apply(*args, **kw):
            self.counts["unet"] += 1
            self.counts["tiling"] |= any(kw.get("tiling", (False, False)))
            return apply(*args, **kw)

        def counted_encode(*args, **kw):
            self.counts["encode"] += 1
            return encode(*args, **kw)

        def counted_decode(params, cfg, z):
            self.counts["decode"] += 1
            img = decode(params, cfg, z)
            self.images.append({
                "latents_finite": bool(z.isfinite().all()),
                "image_finite": bool(img.isfinite().all()),
                "image_constant": float(img.max()) == float(img.min())})
            return img

        unet_mod.apply, vae_mod.encode, vae_mod.decode = \
            counted_apply, counted_encode, counted_decode
        return self

    def __exit__(self, *exc):
        unet_mod, vae_mod = self.mods
        unet_mod.apply, vae_mod.encode, vae_mod.decode = self.saved

    def reset(self):
        """Zero the counts and the decodes' records."""
        self.counts = {"unet": 0, "tiling": False, "encode": 0, "decode": 0}
        self.images.clear()

    def run(self, phase, case, fn, expect, calls, size, failed):
        """fn() once: its line (wall, counts, launches against ``expect``
        and ``calls`` = (UNet calls, encodes, decodes), the decodes'
        checks) emitted; failed checks appended to ``failed``. Returns
        fn's result."""
        import torch

        from gyre_tpu_torch import _build

        self.reset()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.launches)
        seen = (self.counts["unet"], self.counts["encode"],
                self.counts["decode"])
        line = {"phase": phase, "case": case, "wall_s": wall,
                "unet_calls": seen[0], "encodes": seen[1],
                "decodes": seen[2], "launches": launches,
                "expected_launches": expect, "decoded": self.images}
        if out is not None and torch.is_tensor(out):
            line["image_shape"] = list(out.shape)
        emit(line)
        failed.extend(f"{phase} {case}: {what}" for what, bad in (
            (f"calls {seen} != {calls}", seen != tuple(calls)),
            (f"launches {launches} != {expect}", launches != expect),
            ("latents or image not finite", not all(
                d["latents_finite"] and d["image_finite"]
                for d in self.images)),
            ("constant image", any(d["image_constant"]
                                   for d in self.images)),
            (f"image {line.get('image_shape')}",
             out is not None and line.get("image_shape") !=
             [1, size, size, 3])) if bad)
        return out


# the modes phase: for each case, its predicted launches (K1, K2a = K2b)
# from the launch rule of the samplers phase (a UNet call 32 / 44, a VAE
# decode 1 / 28) plus 1 / 20 a VAE encode (4 levels x 2 resnets x 2
# convs, 2 mid resnets x 2 convs; its mid attention), and its UNet calls
# (model calls x UNets a call: hires and graft run two). Under tiling the
# UNet's resnets run no fused kernel. The tiled decode is 9 tiles.
MODE_CASES = {
    # name: (UNet calls, VAE encodes, VAE decodes, K1, K2)
    "img2img": (12, 1, 1, 386, 576),
    "inpaint": (20, 1, 1, 642, 928),
    "inpaint9": (20, 2, 1, 643, 948),
    "depth2img": (20, 1, 1, 642, 928),
    "graft": (40, 2, 1, 1283, 1828),
    "hires": (40, 0, 1, 1281, 1788),
    "tiling": (20, 0, 1, 641, 28),
    "tiled_decode": (0, 0, 9, 9, 252),
}


def _mode_inputs(size: int = 512):
    """A uint8-valued init image [1,H,W,3] (smooth gradients and waves,
    some values clipped to 0 and 1) and a mask [1,H,W,1] (1 regenerates)
    whose edges fall inside 8x8 blocks, so that the latent mask has
    fractional values."""
    import numpy as np

    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.stack([1.3 * yy - 0.1, 0.5 + 0.6 * np.sin(9 * xx * yy),
                    1.2 * xx * (1 - yy)], -1)
    img = np.round(np.clip(img, 0, 1) * 255) / 255
    mask = np.zeros((size, size, 1))
    mask[100:380, 150:350] = 1.0
    return img[None].astype(np.float32), mask[None].astype(np.float32)


def _kept_pixels(mask_np):
    """[H,W] bool: the pixels an inpaint request keeps from its init image,
    those whose keep mask (1 - the mask's 8x8 box mean), bilinearly
    upsampled, is 1. Worked out apart from the port's own resize: for a
    bilinear upsample, ``F.interpolate`` (half-pixel centres, edges
    clamped) weighs the same taps as the JAX package's resize, and at a
    factor of 8 every weight and box mean here is exact in float32."""
    import torch
    import torch.nn.functional as F

    m = torch.from_numpy(mask_np)
    _, h, w, _ = m.shape
    keep = 1.0 - m.reshape(1, h // 8, 8, w // 8, 8, 1).mean(dim=(2, 4))
    up = F.interpolate(keep.permute(0, 3, 1, 2), size=(h, w),
                       mode="bilinear", align_corners=False)
    return (up[0, 0] >= 1.0).numpy()


def phase_modes():
    """Every generation mode on full-width SD1.5 (9- and 5-channel UNets
    for inpaint9 and depth2img), 20 steps k_dpmpp_2m, batch 1: launches
    against MODE_CASES, UNet calls counted, finite latents, a non-constant
    image, the kept pixels of inpaint equal to the init image, and for
    img2img, inpaint and graft the 10-step-chunked run equal in every
    bit."""
    import dataclasses

    import numpy as np
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.models import configs
    from gyre_tpu_torch.models.modelset import random_modelset
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline

    init_np, mask_np = _mode_inputs()
    init = torch.from_numpy(init_np).cuda()
    mask = torch.from_numpy(mask_np).cuda()
    failed = []

    def run(name, fn, chunked=None):
        counted.reset()
        _build.reset_launches()
        t0 = time.perf_counter()
        img = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.launches)
        seen = dict(counted.counts)
        calls, enc, dec, k1, k2 = MODE_CASES[name]
        k2_unet = 0 if seen["tiling"] else 44
        rule = {"flash_attention": 32 * seen["unet"] + seen["decode"] +
                seen["encode"],
                "gn_stats": k2_unet * seen["unet"] + 28 * seen["decode"] +
                20 * seen["encode"]}
        rule["gn_silu_conv3x3"] = rule["gn_stats"]
        expect = {"flash_attention": k1, "gn_stats": k2,
                  "gn_silu_conv3x3": k2}
        line = {"phase": "modes", "case": name, "wall_s": wall,
                "unet_calls": seen["unet"], "encodes": seen["encode"],
                "decodes": seen["decode"], "launches": launches,
                "expected_launches": expect,
                "latents_finite": all(d["latents_finite"]
                                      for d in counted.images),
                "image_shape": list(img.shape),
                "image_min": int(img.min()), "image_max": int(img.max())}
        if chunked is not None:
            other = chunked()
            line["chunked_equal"] = bool(torch.equal(img, other))
        emit(line)
        failed.extend(f"{name}: {what}" for what, bad in (
            (f"UNet calls {seen['unet']}, encodes {seen['encode']}, "
             f"decodes {seen['decode']}, expected {calls}, {enc}, {dec}",
             (seen["unet"], seen["encode"], seen["decode"]) !=
             (calls, enc, dec)),
            (f"launches {launches} != {expect}", launches != expect),
            (f"launches {launches} break the rule {rule}", launches != rule),
            ("latents not finite", not line["latents_finite"]),
            ("constant image", line["image_min"] == line["image_max"]),
            ("10-step chunks differ from one run",
             line.get("chunked_equal") is False)) if bad)
        return img

    base = dict(REQUEST, seeds=[1], output_dtype="uint8")
    chunks = dict(chunk_steps=10, stop_event=threading.Event())
    sd15 = configs.SD15
    try:
        with _Counted() as counted:
            ms = random_modelset(sd15, seed=0, device="cuda")
            pipe = UnifiedPipeline(ms, compute_dtype=torch.bfloat16)
            pipe(**dict(base, init_image=init, strength=0.6))     # warm-up
            kw = dict(base, init_image=init, strength=0.6)
            run("img2img", lambda: pipe(**kw), lambda: pipe(**kw, **chunks))
            kw = dict(base, init_image=init, mask_image=mask, strength=1.0,
                      masked_area_init="shaped")
            img = run("inpaint", lambda: pipe(**kw),
                      lambda: pipe(**kw, **chunks))
            hard = torch.from_numpy(_kept_pixels(mask_np)).cuda()
            want = (init[0] * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
            kept_equal = bool(torch.equal(img[0][hard], want[hard]))
            emit({"phase": "modes", "case": "inpaint", "check": "kept_pixels",
                  "kept": int(hard.sum()), "equal": kept_equal})
            if not kept_equal or not bool(hard.any()) or bool(hard.all()):
                failed.append("inpaint: kept pixels differ from the init "
                              "image")
            run("hires", lambda: pipe(**dict(base, height=1024, width=1024,
                                             hires_fix=True)))
            run("tiling", lambda: pipe(**dict(base, tiling=True)))
            lat = torch.randn((1, 192, 192, 4), device="cuda",
                              generator=torch.Generator("cuda").manual_seed(0))
            run("tiled_decode", lambda: pipe._to_uint8(pipe.vae_decode(lat)))

            ms9 = random_modelset(dataclasses.replace(
                sd15, unet=configs.UNET_SD15_INPAINT), seed=0, device="cuda")
            kw = dict(base, init_image=init, mask_image=mask, strength=1.0)
            pipe9 = UnifiedPipeline(ms9, compute_dtype=torch.bfloat16)
            run("inpaint9", lambda: pipe9(**kw))
            graft = UnifiedPipeline(ms9, compute_dtype=torch.bfloat16,
                                    graft_ms=ms)
            run("graft", lambda: graft(**kw), lambda: graft(**kw, **chunks))
            del pipe9, graft, ms9
            torch.cuda.empty_cache()

            ms5 = random_modelset(dataclasses.replace(
                sd15, unet=configs.UNET_SD15_DEPTH), seed=0, device="cuda")
            pipe5 = UnifiedPipeline(ms5, compute_dtype=torch.bfloat16)
            run("depth2img", lambda: pipe5(**dict(base, init_image=init,
                                                  strength=1.0)))
            del pipe5, ms5, pipe, ms
    finally:
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("modes: " + "; ".join(failed))


# ------------------------------------------------------------- adapters

TI_TOKEN = "<smoke-ti>"
ADAPTER_PROMPT = REQUEST["prompt"] + " " + TI_TOKEN
# kohya names of the LoRA targets, by the port's module names
_KOHYA_TAILS = {"q": "to_q", "k": "to_k", "v": "to_v", "out": "to_out_0"}
_KOHYA_RESNET = {"conv1": "conv1", "conv2": "conv2",
                 "shortcut": "conv_shortcut", "time_emb": "time_emb_proj"}
_KOHYA_TE = {"q": "self_attn_q_proj", "k": "self_attn_k_proj",
             "v": "self_attn_v_proj", "out": "self_attn_out_proj"}


def _median_wall(fn, n: int = 3):
    """(median wall seconds of n calls of fn, each until the card is
    done; the last call's result)."""
    import torch

    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[n // 2], out


def _kohya_name(which: str, path: tuple) -> str | None:
    """The kohya module name of a LoRA target's params path, or None."""
    if which == "te":
        if path[0] != "blocks":
            return None
        if path[2] == "attn":
            return f"lora_te_text_model_encoder_layers_{path[1]}_" \
                   f"{_KOHYA_TE[path[3]]}"
        return f"lora_te_text_model_encoder_layers_{path[1]}_mlp_{path[2]}"
    if path[0] == "mid":
        head = ("mid_block_attentions_0" if path[1] == "attn" else
                f"mid_block_resnets_{0 if path[1] == 'res1' else 1}")
        rest = path[2:]
    elif len(path) > 3 and path[2] in ("attns", "resnets"):
        head = (f"{path[0]}_blocks_{path[1]}_"
                f"{'attentions' if path[2] == 'attns' else 'resnets'}_"
                f"{path[3]}")
        rest = path[4:]
    else:
        return None
    if rest[0] == "blocks":
        b, mod = rest[1], rest[2]
        tail = (f"{mod}_{_KOHYA_TAILS[rest[3]]}" if mod.startswith("attn")
                else {"ff1": "ff_net_0_proj", "ff2": "ff_net_2"}.get(mod))
        return tail and f"lora_unet_{head}_transformer_blocks_{b}_{tail}"
    if rest[0] in ("proj_in", "proj_out"):
        return f"lora_unet_{head}_{rest[0]}"
    return rest[0] in _KOHYA_RESNET and \
        f"lora_unet_{head}_{_KOHYA_RESNET[rest[0]]}" or None


def _lora_targets(cfg):
    """{kohya name: (which, path, Spec)} over every LoRA target of the
    config's UNet and text tower; each name resolves back to its path."""
    from gyre_tpu_torch.models.modelset import map_specs, model_specs
    from gyre_tpu_torch.pipeline import lora

    unet_s, _, text_s = model_specs(cfg)
    out = {}
    for which, specs in (("unet", unet_s), ("te", text_s[0])):
        def visit(path, spec, which=which):
            if path[-1] != "w" or len(path) < 3:
                return
            name = _kohya_name(which, path[:-1])
            if name:
                out[name] = (which, path[:-1], spec)

        map_specs(visit, specs)
    for name, (which, path, _) in out.items():
        if lora.resolve_path(name) != (which, path):
            raise AssertionError(f"{name} does not resolve to {path}")
    return out


def _adapter_states(cfg, seed: int = 0, rank: int = 8):
    """{format: state dict} made with numpy from ``seed``: a kohya LoRA of
    ``rank`` over every target, a LoHa and a LoKr over the text tower's and
    the first and mid transformers' linear layers, a full ``diff`` on a
    linear, a fused 3x3 conv, a 1x1 shortcut and a text layer, and a TI of
    2 vectors; each module's delta scaled (through its alpha) to 1/10 of
    its weights' init spread."""
    import numpy as np

    from gyre_tpu_torch.pipeline import lora

    r = np.random.default_rng(seed)
    targets = _lora_targets(cfg)

    def torch_shape(spec):
        if spec.kind == "conv_hwio":
            kh, kw, ci, co = spec.shape
            return (co, ci, kh, kw)
        return spec.shape

    def add(state, name, entry, spec):
        delta = lora._rebuild_delta(
            {k.split(".")[0]: v for k, v in entry.items()} | {"alpha": rank})
        want = 0.1 / np.sqrt(3.0 * spec.fan_in())
        alpha = rank * want / max(float(delta.std()), 1e-12)
        state.update({f"{name}.{k}": v for k, v in entry.items()})
        state[f"{name}.alpha"] = np.asarray(alpha, np.float32)

    def rnd(*shape):
        return r.standard_normal(shape).astype(np.float32)

    states = {"lora": {}, "loha": {}, "lokr": {}, "diff": {}}
    small = ("lora_te_", "lora_unet_down_blocks_0_attentions_0_",
             "lora_unet_mid_block_attentions_0_")
    for name, (which, path, spec) in targets.items():
        shape = torch_shape(spec)
        out, inn, k = shape[0], shape[1], shape[2:]
        add(states["lora"], name, {
            "lora_up.weight": rnd(out, rank, *((1, 1) if k else ())),
            "lora_down.weight": rnd(rank, inn, *k)}, spec)
        if k or not name.startswith(small):
            continue
        add(states["loha"], name, {
            "hada_w1_a": rnd(out, rank), "hada_w1_b": rnd(rank, inn),
            "hada_w2_a": rnd(out, rank), "hada_w2_b": rnd(rank, inn)}, spec)
        add(states["lokr"], name, {"lokr_w1": rnd(4, 4),
                                   "lokr_w2": rnd(out // 4, inn // 4)},
            spec)
    for name in ("lora_te_text_model_encoder_layers_0_self_attn_q_proj",
                 "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_"
                 "attn2_to_k", "lora_unet_down_blocks_1_resnets_0_conv1",
                 "lora_unet_up_blocks_0_resnets_0_conv_shortcut"):
        spec = targets[name][2]
        states["diff"][f"{name}.diff"] = rnd(*torch_shape(spec)) * np.float32(
            0.1 / np.sqrt(3.0 * spec.fan_in()))
    dim = cfg.text_encoders[0].hidden_size
    states["ti"] = {TI_TOKEN: rnd(2, dim) * np.float32(0.02)}
    return states


def _host_fold_check(base_ms, view_ms, state, scale):
    """(leaves folded, leaves equal to the host fold in every bit): each
    leaf the view does not share with the base against the base leaf plus
    scale * delta in f32 on the host, rounded to the leaf's dtype."""
    import numpy as np
    import torch

    from gyre_tpu_torch.models.modelset import model_specs
    from gyre_tpu_torch.pipeline import lora

    unet_s, _, text_s = model_specs(base_ms.config)
    folded = equal = 0
    for mod, entry in lora.group_modules(state).items():
        which, path = lora.resolve_path(mod)
        trees = ((base_ms.unet_params, view_ms.unet_params, unet_s)
                 if which == "unet" else
                 (base_ms.text_params[0], view_ms.text_params[0], text_s[0]))
        old, new, spec = (lora._tree_get(t, path + ("w",)) for t in trees)
        delta = lora.port_delta(lora._rebuild_delta(entry), spec.kind,
                                old.shape)
        host = (old.cpu().float() + torch.from_numpy(
            delta * np.float32(scale))).to(old.dtype)
        folded += new is not old
        equal += bool(torch.equal(new.cpu(), host))
    return folded, equal


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tree_leaves(v)
    else:
        yield tree


def _serve_yaml(yaml_text: str, extra=()):
    """(manager, Serving, tmp dir) of the server as main builds it, on
    an engines.yaml, no token."""
    import os
    import tempfile

    from gyre_tpu_torch import server

    tmp = tempfile.mkdtemp(prefix="gyre-smoke-")
    cfg = os.path.join(tmp, "engines.yaml")
    with open(cfg, "w") as fh:
        fh.write(yaml_text.replace("{tmp}", tmp))
    args = server.parse_args(
        ["--enginecfg", cfg, "--grpc_port", "0", "--http_port", "0",
         "--cache_path", os.path.join(tmp, "cache"),
         *[a.replace("{tmp}", tmp) for a in extra]])
    manager = server.build_manager(args)
    manager.load_engines()
    return manager, server.serve(args, manager), tmp


def _grpc_generate(port: int):
    import grpc

    from gyre_tpu_torch.services.generate import pb

    channel = grpc.insecure_channel(f"localhost:{port}")
    call = channel.unary_stream(
        "/gooseai.GenerationService/Generate",
        request_serializer=pb.Request.SerializeToString,
        response_deserializer=pb.Answer.FromString)

    def generate(req):
        arts = _image_artifacts(list(call(req, timeout=600)))
        return _png_pixels(arts[0].binary)

    return channel, generate


def phase_adapters():
    """LoRA, LoHa, LoKr, a full diff and a TI on full-width SD1.5 through
    the manager's adapted views and over gRPC (module docstring, 5c)."""
    import os
    import shutil

    import numpy as np
    import torch
    from safetensors.numpy import save as np_save

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.generated import tensors_pb2 as tpb
    from gyre_tpu_torch.models import configs
    from gyre_tpu_torch.services.generate import pb, state_digest

    states = _adapter_states(configs.SD15)
    manager, serving, tmp = _serve_yaml(
        "- {id: sd15, default: true, model: {preset: sd15, seed: 0}}\n",
        ["--local_resource", "smoke={tmp}"])
    channel = None
    failed = []
    try:
        base_view = manager.dispatch_view("sd15")
        base_ms = base_view.pipe.ms
        snapshot = [t.clone() for t in _tree_leaves(
            [base_ms.unet_params, base_ms.text_params])]
        ev = threading.Event()
        kw = dict(REQUEST, prompt=ADAPTER_PROMPT, seeds=[7],
                  output_dtype="uint8", chunk_steps=10, stop_event=ev)

        def image(view):
            return view.pipe(**kw)[0].cpu().numpy()

        image(base_view)                                 # warm-up
        base_wall, base = _median_wall(lambda: image(base_view))
        # the seconds of each fold the dispatcher is held for (its solo
        # job: the uploads and adds), apart from the host work before it
        build, job_s = manager._build_adapted, []

        def timed_build(*args):
            t0 = time.perf_counter()
            view = build(*args)
            torch.cuda.synchronize()
            job_s.append(time.perf_counter() - t0)
            return view
        manager._build_adapted = timed_build
        scale = 0.8
        views = {}
        for fmt in ("lora", "loha", "lokr", "diff", "ti"):
            state = states[fmt]
            t0 = time.perf_counter()
            if fmt == "ti":
                view = manager.adapted_pipeline(
                    "sd15", tis=[(state, state_digest(state))])
            else:
                view = manager.adapted_pipeline(
                    "sd15", loras=[(state, scale, state_digest(state))])
            fold_s = time.perf_counter() - t0
            dispatcher_s = job_s[-1]
            views[fmt] = view
            ms = view.pipe.ms
            if fmt == "ti":
                table = ms.text_params[0]["token_embedding"]
                n = len(base_ms.text_params[0]["token_embedding"])
                folded = 1
                equal = int(torch.equal(table[n:].cpu(), torch.from_numpy(
                    state[TI_TOKEN]).to(table.dtype)))
            else:
                folded, equal = _host_fold_check(base_ms, ms, state, scale)
            base_ids = {id(t) for t in _tree_leaves(
                [base_ms.unet_params, base_ms.text_params])}
            added = sum(t.numel() * t.element_size() for t in _tree_leaves(
                [ms.unet_params, ms.text_params]) if id(t) not in base_ids)
            _build.reset_launches()
            img = image(view)
            launches = dict(_build.launches)
            wall, _ = _median_wall(lambda: image(view))
            line = {"phase": "adapters", "case": fmt, "modules": folded,
                    "host_fold_equal": equal, "fold_s": fold_s,
                    "dispatcher_s": dispatcher_s,
                    "bytes_added": added, "wall_s": wall,
                    "base_wall_s": base_wall, "launches": launches,
                    "differs_from_base": bool((img != base).any())}
            emit(line)
            failed.extend(f"{fmt}: {what}" for what, bad in (
                ("no module folded", not folded),
                (f"{folded - equal} leaves differ from the host fold",
                 equal != folded),
                (f"launches {launches}", launches != EXPECTED_LAUNCHES),
                ("image equals the base image",
                 not line["differs_from_base"])) if bad)
        changed = sum(not torch.equal(a, b) for a, b in zip(
            snapshot, _tree_leaves([base_ms.unet_params,
                                    base_ms.text_params])))
        emit({"phase": "adapters", "check": "base_unchanged",
              "leaves": len(snapshot), "changed": changed})
        if changed:
            failed.append(f"{changed} base leaves changed")
        del snapshot

        # a plain request sent while a new LoRA's deltas are rebuilt on its
        # request's thread runs at once: the dispatcher is held only for
        # the fold's uploads and adds
        folds = len(job_s)
        folding = threading.Thread(target=manager.adapted_pipeline, args=(
            "sd15", [(states["lora"], 0.5, state_digest(states["lora"]))]))
        t0 = time.perf_counter()
        folding.start()
        time.sleep(0.5)
        t1 = time.perf_counter()
        manager.dispatcher.submit(base_view, dict(
            REQUEST, seeds=[7], output_dtype="uint8")).result(600)
        during = time.perf_counter() - t1
        folding.join()
        manager._build_adapted = build
        if len(job_s) != folds + 1:
            raise AssertionError("adapters: the fold during a plain "
                                 "request did not run")
        emit({"phase": "adapters", "check": "plain_during_fold",
              "wall_s": during, "fold_s": time.perf_counter() - t0,
              "dispatcher_s": job_s[-1], "base_wall_s": base_wall})
        # held for the host work too, it would wait most of the fold
        if during > job_s[-1] + 4 * base_wall:
            failed.append(f"a plain request took {during:.2f} s during a "
                          "fold")

        # over gRPC: the LoRA as the lora field, raw bytes, an upload with
        # cache_control then its cache_id, and a url under
        # --local_resource; the TI with token_overrides
        lora = states["lora"]
        raw = np_save(lora)
        with open(os.path.join(tmp, "smoke-lora.safetensors"), "wb") as fh:
            fh.write(raw)
        channel, generate = _grpc_generate(serving.grpc_port)
        want = {"lora": image(views["lora"]), "ti": image(views["ti"])}

        def request(kind, fill, seed=7):
            req = _generate_request(seed)
            req.prompt[0].text = ADAPTER_PROMPT
            prompt = req.prompt.add()
            prompt.artifact.type = (pb.ARTIFACT_TOKEN_EMBEDDING
                                    if kind == "ti" else pb.ARTIFACT_LORA)
            fill(prompt)
            return req

        def lora_field(prompt, state=lora):
            for k, v in state.items():
                prompt.artifact.lora.lora.tensors.add(key=k, tensor=tpb.Tensor(
                    dtype=tpb.DT_FLOAT32, shape=list(np.shape(v)),
                    data=np.ascontiguousarray(v, np.float32).tobytes()))
            prompt.parameters.weight = scale

        def with_data(**fields):
            def fill(prompt):
                for k, v in fields.items():
                    if k == "cache_control":
                        prompt.artifact.cache_control.cache_id = v
                        prompt.artifact.cache_control.max_age = 600
                    else:
                        setattr(prompt.artifact, k, v)
                prompt.parameters.weight = scale
            return fill

        def ti_fill(prompt):
            prompt.artifact.token_embedding.text = "<orig>"
            vec = states["ti"][TI_TOKEN]
            prompt.artifact.token_embedding.tensor.CopyFrom(tpb.Tensor(
                dtype=tpb.DT_FLOAT32, shape=list(vec.shape),
                data=vec.tobytes()))
            prompt.parameters.token_overrides.add(original_token="<orig>",
                                                  token=TI_TOKEN)

        cases = [("lora_field", "lora", lora_field),
                 ("binary", "lora", with_data(binary=raw)),
                 ("cache_control", "lora", with_data(binary=raw,
                                                     cache_control="smk")),
                 ("cache_id", "lora", with_data(cache_id="smk")),
                 ("url", "lora", with_data(
                     url="file:smoke/smoke-lora.safetensors")),
                 ("ti_overrides", "ti", ti_fill)]
        for name, kind, fill in cases:
            t0 = time.perf_counter()
            got = generate(request(kind, fill))
            diff = int(np.abs(got.astype(int) - want[kind].astype(int)).max())
            emit({"phase": "adapters", "grpc": name,
                  "wall_s": time.perf_counter() - t0,
                  "max_diff_to_in_process": diff})
            if diff > 1:
                failed.append(f"gRPC {name}: {diff} levels off the "
                              "in-process image")
        # two distinct LoRAs without a uuid give two images
        other = {k: v[::-1].copy() if v.ndim else v
                 for k, v in states["lora"].items()}
        a = generate(request("lora", lora_field, seed=8))
        b = generate(request("lora", lambda p: lora_field(p, other), seed=8))
        emit({"phase": "adapters", "check": "distinct_loras",
              "images_differ": bool((a != b).any())})
        if not (a != b).any():
            failed.append("two distinct LoRAs gave one image")

        # a base and a LoRA request queued together are not merged; two
        # base requests are
        start = len(manager.dispatcher.dispatched)
        jobs = [(base_view, 11), (base_view, 12), (views["lora"], 13)]
        futures = [manager.dispatcher.submit(
            v, dict(REQUEST, seeds=[s], output_dtype="uint8"))
            for v, s in jobs]
        for f in futures:
            f.result(600)
        batches = sorted(n for n, _ in manager.dispatcher.dispatched[start:])
        emit({"phase": "adapters", "check": "coalescing",
              "jobs_per_batch": batches})
        if batches != [1, 2]:
            failed.append(f"base and LoRA jobs batched as {batches}")
    finally:
        if channel is not None:
            channel.close()
        serving.stop(0)
        manager.dispatcher.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("adapters: " + "; ".join(failed))


# ---------------------------------------------------------------- hints

# launches of one hinted batch-1 request (20 UNet calls): a ControlNet
# adds its 7 transformers x 2 attentions (K1) and 10 resnets x 2 fused
# convs (K2a, K2b) to every UNet call; a T2I adapter runs no kernel
HINT_CASES = {
    # name: (hints, K1, K2)
    "controlnet_balanced": ([("cn", "balanced")], 921, 1308),
    "controlnet_prompt": ([("cn", "prompt")], 921, 1308),
    "controlnet_hint": ([("cn", "hint")], 921, 1308),
    "two_controlnets": ([("cn", "balanced"), ("cn2", "hint")], 1201, 1708),
    "controlnet_t2i": ([("cn", "prompt"), ("t2i", "balanced")], 921, 1308),
    "t2i_balanced": ([("t2i", "balanced")], 641, 908),
    "t2i_hint": ([("t2i", "hint")], 641, 908),
    "controlnet_masked": ([("cn", "balanced", "mask")], 921, 1308),
}


# the hint keys of each protocol priority
HINT_PRIORITIES = {"balanced": {}, "prompt": {"soft_injection": True},
                   "hint": {"soft_injection": True, "cfg_only": True}}
HINT_ROUNDS = 5


def _live_controlnet(cfg, seed: int):
    """A random ControlNet whose zero convs (and the conditioning
    embedding's output conv) are random too, so that it conditions."""
    import torch

    from gyre_tpu_torch.models import controlnet

    p = controlnet.random_controlnet(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    with torch.inference_mode():
        for zc in p["zero_convs"] + [p["mid_zero"],
                                     p["cond_embed"]["conv_out"]]:
            zc["w"] = (torch.randn(zc["w"].shape, generator=gen,
                                   device="cuda") * 0.1).to(zc["w"].dtype)
    return p


def _hint_image(h: int, w: int, seed: int):
    """A hint-like image [1,H,W,3] in [0,1]: rings and bars."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    a = 0.5 + 0.5 * np.sin(40 * np.hypot(yy - 0.5, xx - 0.4) + seed)
    b = (np.sin(25 * (xx + 0.3 * yy) + seed) > 0).astype(np.float64)
    return np.stack([a, b, a * b], -1)[None].astype(np.float32)


def _hint_kit():
    """(models, hint images, the masked cases' mask, hints(spec, mask)):
    two live ControlNets and a full T2I adapter at SD1.5 width on the
    card; hints() makes a request's hints from a HINT_CASES spec."""
    import torch

    from gyre_tpu_torch.models import configs, t2i_adapter

    ucfg = configs.SD15.unet
    models = {"cn": ("controlnet", _live_controlnet(ucfg, 1)),
              "cn2": ("controlnet", _live_controlnet(ucfg, 2)),
              "t2i": ("t2i", t2i_adapter.random_t2i_adapter(
                  t2i_adapter.FULL_CHANNELS, seed=3, device="cuda"))}
    cond = [torch.from_numpy(_hint_image(512, 512, s)).cuda()
            for s in (0, 1)]
    mask = torch.zeros((1, 512, 512, 1), device="cuda")
    mask[:, :, 256:] = 1.0

    def hints(spec, masks=None):
        out = []
        for i, (name, prio, *extra) in enumerate(spec):
            kind, params = models[name]
            out.append({"params": params, "kind": kind, "image": cond[i],
                        "scale": 1.0, **HINT_PRIORITIES[prio],
                        **({"mask": masks} if extra else {})})
        return out
    return models, cond, mask, hints


def phase_hints():
    """ControlNets and T2I adapters on full-width SD1.5 (module docstring,
    5d)."""
    import os
    import shutil

    import numpy as np
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.models import configs, controlnet, load
    from gyre_tpu_torch.models.modelset import random_preset
    from gyre_tpu_torch.ops.images import encode_png, rescale
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline
    from gyre_tpu_torch.services.generate import pb

    ucfg = configs.SD15.unet
    models, cond, mask, hints = _hint_kit()
    ms = random_preset("sd15", seed=0, device="cuda")
    pipe = UnifiedPipeline(ms, compute_dtype=torch.bfloat16)
    kw = dict(REQUEST, seeds=[9], output_dtype="uint8")

    failed = []
    pipe(**kw)                                           # warm-up
    base = pipe(**kw)
    images, lines = {}, {}
    for name, (spec, k1, k2) in HINT_CASES.items():
        pipe(**kw, hints=hints(spec, mask))              # warm-up
        _build.reset_launches()
        img = pipe(**kw, hints=hints(spec, mask))
        launches = dict(_build.launches)
        expect = {"flash_attention": k1, "gn_stats": k2,
                  "gn_silu_conv3x3": k2}
        images[name] = img
        lines[name] = line = {
            "phase": "hints", "case": name, "launches": launches,
            "expected_launches": expect,
            "differs_from_base": bool((img != base).any()),
            "image_min": int(img.min()), "image_max": int(img.max())}
        failed.extend(f"{name}: {what}" for what, bad in (
            (f"launches {launches} != {expect}", launches != expect),
            ("image equals the no-hint image", not line["differs_from_base"]),
            ("constant image", line["image_min"] == line["image_max"])) if bad)
    # walls: HINT_ROUNDS rounds over the plain request and every case, in
    # order on even rounds and in reverse on odd ones, so that no case
    # always follows the same one; a case's wall is its median
    calls = {"plain": lambda: pipe(**kw), **{
        name: functools.partial(lambda spec: pipe(**kw, hints=hints(
            spec, mask)), spec) for name, (spec, _, _) in HINT_CASES.items()}}
    walls = {name: [] for name in calls}
    for r in range(HINT_ROUNDS):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            walls[name].append(_median_wall(calls[name], 1)[0])
    median = {n: sorted(w)[len(w) // 2] for n, w in walls.items()}
    for name, line in lines.items():
        emit({**line, "wall_s": median[name], "walls_s": walls[name],
              "base_wall_s": median["plain"]})
    # cfg_only against the like-for-like case (prompt: the same layer
    # weights on both halves), paired within each round
    emit({"phase": "hints", "check": "walls", "rounds": HINT_ROUNDS,
          "plain_walls_s": walls["plain"],
          "cfg_only_saving_s": [p - h for p, h in zip(
              walls["controlnet_prompt"], walls["controlnet_hint"])]})
    prios = [images[f"controlnet_{p}"] for p in HINT_PRIORITIES]
    if any(torch.equal(a, b) for i, a in enumerate(prios)
           for b in prios[i + 1:]):
        failed.append("two hint priorities gave one image")
    # exact: a zero mask, and a ControlNet with zero convs (as
    # random_controlnet makes one), give the no-hint image in every bit
    zero = torch.zeros_like(mask)
    exact = {
        "zero_mask": pipe(**kw, hints=hints([("cn", "hint", "mask")], zero)),
        "zero_controlnet": pipe(**kw, hints=[{
            "params": controlnet.random_controlnet(ucfg, seed=4,
                                                   device="cuda"),
            "image": cond[0], "soft_injection": True, "cfg_only": True}])}
    for name, img in exact.items():
        equal = bool(torch.equal(img, base))
        emit({"phase": "hints", "check": name, "equals_no_hint": equal})
        if not equal:
            failed.append(f"{name}: differs from the no-hint image")
    del pipe, ms
    torch.cuda.empty_cache()

    # over gRPC through the engine's hintset: the live ControlNet saved as
    # a checkpoint, a hint image of another size than the request's
    manager = serving = channel = None
    tmp = None
    try:
        import tempfile

        tmp = tempfile.mkdtemp(prefix="gyre-smoke-cn-")
        load.write_safetensors(os.path.join(tmp, "cn.safetensors"),
                               load.export_controlnet_state(
                                   models["cn"][1], ucfg))
        manager, serving, tmp2 = _serve_yaml(
            "- {id: sd15, default: true, hintset: hs, model: {preset: sd15, "
            "seed: 0}}\n"
            f"- {{model_id: smoke-cn, model: {tmp}/cn.safetensors}}\n"
            "- {hintset_id: hs, controlnet/canny: {aliases: [canny], "
            "model: '@smoke-cn'}}\n")
        shutil.rmtree(tmp2, ignore_errors=True)
        channel, generate = _grpc_generate(serving.grpc_port)
        hint_np = np.round(_hint_image(384, 640, 5)[0] * 255).astype(
            np.uint8)
        params = manager.hint_model("canny", "sd15")["params"]
        view = manager.dispatch_view("sd15")
        from gyre_tpu_torch.ops.images import decode_png

        png = encode_png(hint_np)
        cond_req = rescale(torch.from_numpy(decode_png(png)), 512,
                           512).numpy()[..., :3]
        for prio, enum in (("balanced", pb.HINT_BALANCED),
                           ("prompt", pb.HINT_PRIORITISE_PROMPT),
                           ("hint", pb.HINT_PRIORITISE_HINT)):
            req = _generate_request(21)
            art = req.prompt.add()
            art.artifact.type = pb.ARTIFACT_HINT_IMAGE
            art.artifact.hint_image_type = "canny"
            art.artifact.binary = png
            art.parameters.hint_priority = enum
            t0 = time.perf_counter()
            got = generate(req)
            wall = time.perf_counter() - t0
            want = view.pipe(**dict(
                REQUEST, seeds=[21], output_dtype="uint8", chunk_steps=10,
                stop_event=threading.Event(), hints=[{
                    "params": params, "kind": "controlnet",
                    "image": cond_req, "scale": 1.0,
                    "soft_injection": prio != "balanced",
                    "cfg_only": prio == "hint"}]))[0].cpu().numpy()
            diff = int(np.abs(got.astype(int) - want.astype(int)).max())
            emit({"phase": "hints", "grpc": prio, "wall_s": wall,
                  "hint_image": list(hint_np.shape),
                  "max_diff_to_in_process": diff})
            if diff > 1:
                failed.append(f"gRPC {prio}: {diff} levels off the "
                              "in-process image")
    finally:
        if channel is not None:
            channel.close()
        if serving is not None:
            serving.stop(0)
        if manager is not None:
            manager.dispatcher.stop()
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("hints: " + "; ".join(failed))



# ------------------------------------------------------------- SD2, SDXL


def _engine_bytes(ms) -> dict:
    """Weight bytes of each model of a ModelSet."""
    from gyre_tpu_torch.models.modelset import _leaves

    def size(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))

    return {"unet": size(ms.unet_params), "vae": size(ms.vae_params),
            "text_encoders": [size(t) for t in ms.text_params]}


def phase_sd2():
    """SD2 768² v-prediction (module docstring, 5e)."""
    import numpy as np
    import torch

    from gyre_tpu_torch.manager.manager import EngineManager
    from gyre_tpu_torch.server import build_server

    paths = _c5_paths()
    manager = EngineManager(
        [{"id": "sd21", "default": True,
          "model": {"preset": "sd21", "seed": 0}}],
        device="cuda", batch_max=1, gather_ms=0.0)
    failed = []
    try:
        t0 = time.perf_counter()
        manager.load_engines()
        pipe = manager.pipeline("sd21")
        emit({"phase": "sd2", "load_s": time.perf_counter() - t0,
              "natural_size": manager.natural_size("sd21"),
              "prediction_type": pipe.schedule.prediction_type,
              "weight_bytes": _engine_bytes(pipe.ms)})
        kw = dict(REQUEST, height=768, width=768, seeds=[1],
                  output_dtype="uint8", chunk_steps=10,
                  stop_event=threading.Event())
        n = paths["sd2_img2img_768"][0][0]
        with _Counted() as counted:
            img = counted.run("sd2", "txt2img", lambda: pipe(**kw),
                              _launches(paths["sd2_768"]), (STEPS, 0, 1),
                              768, failed)
            init = img.float() / 255.0
            counted.run(
                "sd2", "img2img",
                lambda: pipe(**dict(kw, seeds=[2], init_image=init,
                                    strength=0.6)),
                _launches(paths["sd2_img2img_768"]), (n, 1, 1), 768, failed)

        # over gRPC without a size: the engine's natural 768²
        server, port = build_server(manager, 0, batch_max=1,
                                    host="localhost")
        channel, generate = _grpc_generate(port)
        try:
            req = _generate_request(3, "sd21")
            req.image.height = req.image.width = 0
            t0 = time.perf_counter()
            image = generate(req)
            emit({"phase": "sd2", "case": "grpc_natural_size",
                  "wall_s": time.perf_counter() - t0,
                  "shape": list(image.shape)})
            if image.shape != (768, 768, 3) or int(np.ptp(image)) == 0:
                failed.append("sd2 grpc: no non-constant 768x768 image")
        finally:
            channel.close()
            server.stop(0).wait()
    finally:
        manager.dispatcher.stop()
        del manager
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


# the size ids of phase_sdxl's second base call, in place of 1024²
SDXL_OTHER_SIZE = (768, 1344)


def phase_sdxl():
    """SDXL base and refiner at 1024² (module docstring, 5f)."""
    import grpc
    import numpy as np
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.manager.manager import EngineManager
    from gyre_tpu_torch.server import build_server
    from gyre_tpu_torch.services.generate import pb

    paths = _c5_paths()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    manager = EngineManager(
        [{"id": "sdxl", "default": True,
          "model": {"preset": "sdxl", "seed": 0}},
         {"id": "sdxl-refiner", "model": {"preset": "sdxl-refiner",
                                          "seed": 0}}],
        device="cuda", batch_max=1, gather_ms=0.0)
    failed = []
    try:
        t0 = time.perf_counter()
        manager.load_engines()
        base = manager.pipeline("sdxl")
        refiner = manager.pipeline("sdxl-refiner")
        emit({"phase": "sdxl", "load_s": time.perf_counter() - t0,
              "natural_size": [manager.natural_size("sdxl"),
                               manager.natural_size("sdxl-refiner")],
              "weight_bytes": {"sdxl": _engine_bytes(base.ms),
                               "sdxl-refiner": _engine_bytes(refiner.ms)},
              "allocated_before_bytes": allocated_before,
              "allocated_bytes": torch.cuda.memory_allocated()})
        kw = dict(REQUEST, height=1024, width=1024, seeds=[1],
                  output_dtype="uint8", chunk_steps=10,
                  stop_event=threading.Event())
        base_launches = _launches(paths["sdxl_1024"])
        refiner_launches = _launches(paths["refiner_img2img_1024"])
        n = paths["refiner_img2img_1024"][0][0]
        with _Counted() as counted:
            img = counted.run("sdxl", "txt2img", lambda: base(**kw),
                              base_launches, (STEPS, 0, 1), 1024, failed)
            # only the size ids change: the pooled text and the time ids
            # reach the UNet when the image changes
            added_cond = base._added_cond

            def other_size(prompt, negative, batch, guided, *_):
                return added_cond(prompt, negative, batch, guided,
                                  *SDXL_OTHER_SIZE)

            base._added_cond = other_size
            try:
                other = counted.run("sdxl", "other_size_ids",
                                    lambda: base(**kw), base_launches,
                                    (STEPS, 0, 1), 1024, failed)
            finally:
                del base._added_cond
            differs = not bool(torch.equal(img, other))
            emit({"phase": "sdxl", "check": "size_ids_change_the_image",
                  "size_ids": SDXL_OTHER_SIZE, "differs": differs})
            if not differs:
                failed.append("sdxl: other size ids gave the same image")
            counted.run(
                "sdxl", "refiner_img2img",
                lambda: refiner(**dict(kw, init_image=img.float() / 255.0,
                                       strength=0.34)),
                refiner_launches, (n, 1, 1), 1024, failed)

        # base -> refiner (start 0.34) -> RETURN over gRPC, both at the
        # engines' natural size
        server, port = build_server(manager, 0, batch_max=1,
                                    host="localhost")
        channel = grpc.insecure_channel(f"localhost:{port}")
        try:
            chain = pb.ChainRequest(request_id="smoke-chain")
            for sid, engine, start, target in (
                    ("base", "sdxl", None, "refine"),
                    ("refine", "sdxl-refiner", 0.34, None)):
                stage = chain.stage.add()
                stage.id = sid
                req = _generate_request(5, engine)
                req.image.height = req.image.width = 0
                if start is not None:
                    req.image.parameters[0].schedule.start = start
                stage.request.CopyFrom(req)
                on = stage.on_status.add()
                if target:
                    on.action.append(pb.STAGE_ACTION_PASS)
                    on.target = target
                else:
                    on.action.append(pb.STAGE_ACTION_RETURN)
            call = channel.unary_stream(
                "/gooseai.GenerationService/ChainGenerate",
                request_serializer=pb.ChainRequest.SerializeToString,
                response_deserializer=pb.Answer.FromString)
            _build.reset_launches()
            t0 = time.perf_counter()
            answers = list(call(chain, timeout=900))
            wall = time.perf_counter() - t0
            launches = dict(_build.launches)
            expect = {k: base_launches[k] + refiner_launches[k]
                      for k in base_launches}
            images = [_png_pixels(a.binary)
                      for a in _image_artifacts(answers)]
            emit({"phase": "sdxl", "case": "grpc_chain", "wall_s": wall,
                  "answers": [a.answer_id for a in answers],
                  "shapes": [list(i.shape) for i in images],
                  "launches": launches, "expected_launches": expect})
            if [i.shape for i in images] != [(1024, 1024, 3)] or \
                    int(np.ptp(images[0])) == 0:
                failed.append("sdxl chain: no non-constant 1024x1024 "
                              "image")
            if launches != expect:
                failed.append(f"sdxl chain: launches {launches} != "
                              f"{expect}")
        finally:
            channel.close()
            server.stop(0).wait()
        t0 = time.perf_counter()
        batch = manager.suggest_max_batch("sdxl")
        emit({"phase": "sdxl", "check": "suggest_max_batch",
              "size": manager.natural_size("sdxl"), "max_batch": batch,
              "bytes_per_image": manager._probe_bytes_per_image(
                  "sdxl", 1024, 1024),
              "seconds": time.perf_counter() - t0,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    finally:
        manager.dispatcher.stop()
        del manager
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


def _generate_request(seed: int, engine_id: str = "sd15"):
    from gyre_tpu_torch.services.generate import pb

    req = pb.Request(engine_id=engine_id, request_id=f"smoke-{seed}")
    req.prompt.add().text = REQUEST["prompt"]
    neg = req.prompt.add()
    neg.text = REQUEST["negative_prompt"]
    neg.parameters.weight = -1.0
    img = req.image
    img.height, img.width = REQUEST["height"], REQUEST["width"]
    img.steps, img.samples = REQUEST["steps"], 1
    img.seed.append(seed)
    img.transform.diffusion = pb.SAMPLER_K_DPMPP_2M
    img.parameters.add().sampler.cfg_scale = REQUEST["guidance_scale"]
    return req


def phase_serve():
    """EngineManager + shared dispatcher under 4 concurrent requests, then
    two Generate calls over gRPC."""
    import numpy as np
    import torch

    from gyre_tpu_torch.manager.manager import EngineManager

    manager = EngineManager(
        [{"id": "sd15", "default": True,
          "model": {"preset": "sd15", "seed": 0}}],
        device="cuda", batch_max=4, gather_ms=200.0)
    try:
        manager.load_engines()
        view = manager.dispatch_view("sd15")
        n = 4
        results = [None] * n
        errors = []

        def client(i):
            try:
                ev = threading.Event()
                kw = dict(REQUEST, seeds=[100 + i], output_dtype="uint8",
                          chunk_steps=10, stop_event=ev)
                results[i] = manager.dispatcher.submit(view, kw,
                                                       ev).result(600)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"concurrent requests failed: {errors}")
        for r in results:
            if r is None or tuple(np.asarray(r).shape) != (1, 512, 512, 3):
                raise AssertionError("a request returned no image")
        merged = max(rows for _, rows in manager.dispatcher.dispatched)
        emit({"phase": "serve", "requests": n, "wall_s": wall,
              "dispatched": manager.dispatcher.dispatched,
              "merged_batch": merged,
              "coalesced_requests": manager.dispatcher.coalesced_requests})
        if merged != n:
            raise AssertionError(f"{n} concurrent requests merged into "
                                 f"batches {manager.dispatcher.dispatched}")
        phase_grpc(manager)
    finally:
        manager.dispatcher.stop()
        del manager
        torch.cuda.empty_cache()


def phase_grpc(manager, engine_id: str = "sd15", seeds=(200, 201),
               phase: str = "grpc"):
    import grpc

    from gyre_tpu_torch.server import build_server
    from gyre_tpu_torch.services.generate import pb

    server, port = build_server(manager, 0, batch_max=4,
                                host="localhost")
    try:
        channel = grpc.insecure_channel(f"localhost:{port}")
        call = channel.unary_stream(
            "/gooseai.GenerationService/Generate",
            request_serializer=pb.Request.SerializeToString,
            response_deserializer=pb.Answer.FromString)
        sizes = []
        t0 = time.perf_counter()
        for seed in seeds:
            answers = list(call(_generate_request(seed, engine_id),
                                timeout=600))
            arts = [a for ans in answers for a in ans.artifacts
                    if a.type == pb.ARTIFACT_IMAGE]
            if len(arts) != 1 or arts[0].mime != "image/png" or \
                    not arts[0].binary.startswith(b"\x89PNG\r\n\x1a\n"):
                raise AssertionError(f"Generate(seed={seed}) returned no "
                                     "PNG artifact")
            sizes.append(len(arts[0].binary))
        emit({"phase": phase, "engine": engine_id, "requests": len(seeds),
              "png_bytes": sizes, "wall_s": time.perf_counter() - t0})
        channel.close()
    finally:
        server.stop(0).wait()


HTTP_TOKEN = "smoke-token"


def _png_pixels(data: bytes):
    """uint8 [H,W,3] of a PNG written by the port's encoder (one zlib
    stream of filter-0 RGB scanlines), so that no image library is
    needed."""
    import struct
    import zlib

    import numpy as np

    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise AssertionError("not a PNG")
    off, idat, width, height = 8, b"", 0, 0
    while off < len(data):
        (length,), tag = struct.unpack(">I", data[off:off + 4]), \
            data[off + 4:off + 8]
        chunk = data[off + 8:off + 8 + length]
        if tag == b"IHDR":
            width, height = struct.unpack(">II", chunk[:8])
            if chunk[8:10] != b"\x08\x02":
                raise AssertionError("PNG is not 8-bit RGB")
        elif tag == b"IDAT":
            idat += chunk
        off += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + 3 * width)
    if raw[:, 0].any():
        raise AssertionError("PNG uses scanline filters")
    return raw[:, 1:].reshape(height, width, 3)


def _image_artifacts(answers, mime: str = "image/png"):
    from gyre_tpu_torch.services.generate import pb

    arts = [a for ans in answers for a in ans.artifacts
            if a.type == pb.ARTIFACT_IMAGE]
    if not arts or any(a.mime != mime for a in arts):
        raise AssertionError(f"expected {mime} artifacts, got "
                             f"{[a.mime for a in arts]}")
    return arts


def phase_http():
    """The server's gRPC and HTTP surface on the card (module docstring,
    phase 7)."""
    import base64
    import importlib.util
    import os
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    import grpc
    import numpy as np
    import torch

    from gyre_tpu_torch import _build, server
    from gyre_tpu_torch.generated import engines_pb2 as epb
    from gyre_tpu_torch.http.grpc_web_client import WebChannel
    from gyre_tpu_torch.ops.images import encode_png
    from gyre_tpu_torch.services.generate import pb

    tmp = tempfile.mkdtemp(prefix="gyre-smoke-http-")
    cfg = os.path.join(tmp, "smoke-http.yaml")
    with open(cfg, "w") as fh:
        fh.write("- {id: sd15, default: true, model: {preset: sd15, "
                 "seed: 0}}\n- {id: sd15-inpaint, model: {preset: "
                 "sd15-inpaint, seed: 0}}\n")
    args = server.parse_args(
        ["--enginecfg", cfg, "--grpc_port", "0", "--http_port", "0",
         "--access_token", HTTP_TOKEN, "--cache_path",
         os.path.join(tmp, "cache")])
    manager = server.build_manager(args)
    serving = None
    try:
        manager.load_engines()
        serving = server.serve(args, manager)
        base = f"http://localhost:{serving.http_port}"
        auth = {"Authorization": f"Bearer {HTTP_TOKEN}"}

        def route(name, t0, nbytes, **extra):
            emit({"phase": "http", "route": name,
                  "wall_s": time.perf_counter() - t0, "bytes": nbytes,
                  **extra})

        def post(path, body, headers):
            req = urllib.request.Request(base + path, data=body,
                                         headers=headers, method="POST")
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, resp.headers["Content-Type"], \
                    resp.read()

        # 1. REST text-to-image, as JSON and as PNG (launches counted)
        rest = json.dumps({
            "text_prompts": [{"text": REQUEST["prompt"]},
                             {"text": REQUEST["negative_prompt"],
                              "weight": -1.0}],
            "height": REQUEST["height"], "width": REQUEST["width"],
            "steps": REQUEST["steps"], "cfg_scale": REQUEST["guidance_scale"],
            "sampler": "K_DPMPP_2M", "seed": 400}).encode()
        path = "/v1/generation/sd15/text-to-image"
        t0 = time.perf_counter()
        status, ctype, body = post(path, rest, {
            **auth, "Content-Type": "application/json",
            "Accept": "application/json"})
        arts = json.loads(body)["artifacts"]
        json_png = base64.b64decode(arts[0]["base64"])
        route("rest_json", t0, len(body), status=status)
        if status != 200 or ctype != "application/json" or \
                len(arts) != 1 or arts[0]["seed"] != 400:
            raise AssertionError(f"REST JSON answered {status} {ctype} "
                                 f"{[a['seed'] for a in arts]}")
        _build.reset_launches()
        t0 = time.perf_counter()
        status, ctype, png = post(path, rest, {
            **auth, "Content-Type": "application/json",
            "Accept": "image/png"})
        launches = dict(_build.launches)
        route("rest_png", t0, len(png), status=status, launches=launches,
              expected=EXPECTED_LAUNCHES)
        if status != 200 or ctype != "image/png":
            raise AssertionError(f"REST PNG answered {status} {ctype}")
        if launches != EXPECTED_LAUNCHES:
            raise AssertionError(f"REST request: launch counts {launches} "
                                 f"!= {EXPECTED_LAUNCHES}")
        img = _png_pixels(png)
        diff = int(np.abs(img.astype(int) -
                          _png_pixels(json_png).astype(int)).max())
        shape = (REQUEST["height"], REQUEST["width"], 3)
        if img.shape != shape or img.min() == img.max() or diff > 1:
            raise AssertionError(f"REST images {img.shape}, equal seeds "
                                 f"differ by {diff}")

        # 1b. REST image-to-image and masking on the SD 1.5 engine, the
        # init image a PNG; masking keeps the init image where the mask
        # is black
        init_np, mask_np = _mode_inputs()
        init_u8 = np.round(init_np[0] * 255).astype(np.uint8)
        mask_u8 = np.repeat(np.round(mask_np[0] * 255).astype(np.uint8), 3,
                            axis=-1)
        def b64(a):
            return base64.b64encode(encode_png(a)).decode()

        for kind, extra in (
                ("image-to-image", {"image_strength": 0.4}),
                ("image-to-image/masking", {
                    "mask_image": b64(mask_u8),
                    "mask_source": "MASK_IMAGE_WHITE"})):
            body = json.loads(rest)
            body.update(init_image=b64(init_u8), seed=410, **extra)
            t0 = time.perf_counter()
            status, ctype, png = post(f"/v1/generation/sd15/{kind}",
                                      json.dumps(body).encode(), {
                                          **auth,
                                          "Content-Type": "application/json",
                                          "Accept": "image/png"})
            px = _png_pixels(png)
            kept = _kept_pixels(mask_np)
            line = {"status": status, "content_type": ctype,
                    "shape": list(px.shape)}
            if kind.endswith("masking"):
                line["kept_equal"] = bool((px[kept] == init_u8[kept]).all())
            route(f"rest_{kind}", t0, len(png), **line)
            if status != 200 or ctype != "image/png" or px.shape != \
                    init_u8.shape or px.min() == px.max() or \
                    line.get("kept_equal") is False:
                raise AssertionError(f"REST {kind}: {line}")

        channel = grpc.insecure_channel(f"localhost:{serving.grpc_port}")
        meta = [("authorization", f"Bearer {HTTP_TOKEN}")]

        def rpc(kind, method, req_cls, resp_cls):
            return getattr(channel, kind)(
                f"/gooseai.GenerationService/{method}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)

        generate = rpc("unary_stream", "Generate", pb.Request, pb.Answer)

        # 2. Async round trip against a synchronous Generate; a cancel
        start = rpc("unary_unary", "AsyncGenerate", pb.Request,
                    pb.AsyncHandle)
        poll = rpc("unary_unary", "AsyncResult", pb.AsyncHandle,
                   pb.AsyncAnswer)
        cancel = rpc("unary_unary", "AsyncCancel", pb.AsyncHandle,
                     pb.AsyncCancelAnswer)
        t0 = time.perf_counter()
        handle = start(_generate_request(401), metadata=meta, timeout=60)
        answers, polls = [], 0
        while True:
            res = poll(handle, metadata=meta, timeout=60)
            answers.extend(res.answer)
            polls += 1
            if res.complete:
                break
            if time.perf_counter() - t0 > 600:
                raise AssertionError("AsyncResult never completed")
        async_png = _image_artifacts(answers)[0].binary
        route("async", t0, len(async_png), polls=polls,
              status=res.status.message)
        t0 = time.perf_counter()
        sync_png = _image_artifacts(list(generate(
            _generate_request(401), metadata=meta, timeout=600)))[0].binary
        diff = int(np.abs(_png_pixels(async_png).astype(int) -
                          _png_pixels(sync_png).astype(int)).max())
        route("grpc_sync", t0, len(sync_png), async_max_abs_diff_uint8=diff)
        if diff > 1:
            raise AssertionError(f"Async and sync images differ by {diff}")
        t0 = time.perf_counter()
        second = start(_generate_request(402), metadata=meta, timeout=60)
        cancel(second, metadata=meta, timeout=60)
        try:
            poll(second, metadata=meta, timeout=60)
            raise AssertionError("a cancelled handle still answers")
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.NOT_FOUND:
                raise
        route("async_cancel", t0, 0, after_cancel="NOT_FOUND")

        # 3. ChainGenerate: two RETURN stages
        chain = pb.ChainRequest(request_id="smoke-chain")
        for seed in (403, 404):
            stage = chain.stage.add(id=f"stage-{seed}")
            stage.request.CopyFrom(_generate_request(seed))
            stage.on_status.add().action.append(pb.STAGE_ACTION_RETURN)
        t0 = time.perf_counter()
        answers = list(rpc("unary_stream", "ChainGenerate", pb.ChainRequest,
                           pb.Answer)(chain, metadata=meta, timeout=600))
        pngs = [a.binary for a in _image_artifacts(answers)]
        route("chain", t0, sum(map(len, pngs)), answers=len(answers),
              seeds=[a.artifacts[0].seed for a in answers])
        if len(answers) != 2 or [a.artifacts[0].seed for a in answers] != \
                [403, 404]:
            raise AssertionError(f"ChainGenerate gave {len(answers)} answers")

        # 3b. ChainGenerate with PASS: stage 1's PNG is stage 2's init
        # image (img2img, schedule start 0.5); only stage 2 answers
        chain = pb.ChainRequest(request_id="smoke-pass")
        first = chain.stage.add(id="first")
        first.request.CopyFrom(_generate_request(407))
        on = first.on_status.add()
        on.action.append(pb.STAGE_ACTION_PASS)
        on.target = "second"
        second = chain.stage.add(id="second")
        second.request.CopyFrom(_generate_request(408))
        second.request.image.parameters.add().schedule.start = 0.5
        second.on_status.add().action.append(pb.STAGE_ACTION_RETURN)
        t0 = time.perf_counter()
        answers = list(rpc("unary_stream", "ChainGenerate", pb.ChainRequest,
                           pb.Answer)(chain, metadata=meta, timeout=600))
        pngs = [a.binary for a in _image_artifacts(answers)]
        route("chain_pass", t0, sum(map(len, pngs)), answers=len(answers),
              answer_ids=[a.answer_id for a in answers])
        if [a.answer_id for a in answers] != ["smoke-pass-second"] or \
                _png_pixels(pngs[0]).shape != shape:
            raise AssertionError(f"ChainGenerate PASS gave {len(answers)} "
                                 "answers")

        # 3c. ListEngines: both engines ready, the 9-channel one too
        listed = channel.unary_unary(
            "/gooseai.EnginesService/ListEngines",
            request_serializer=epb.ListEnginesRequest.SerializeToString,
            response_deserializer=epb.Engines.FromString)(
                epb.ListEnginesRequest(), metadata=meta, timeout=60).engine
        ready = {e.id: e.ready for e in listed}
        emit({"phase": "http", "route": "list_engines", "ready": ready})
        if ready != {"sd15": True, "sd15-inpaint": True}:
            raise AssertionError(f"ListEngines ready: {ready}")

        # 4. gRPC-Web through the HTTP port
        web = WebChannel(base, token=HTTP_TOKEN)
        t0 = time.perf_counter()
        answers = list(web.unary_stream(
            "/gooseai.GenerationService/Generate",
            pb.Request.SerializeToString, pb.Answer.FromString)(
                _generate_request(405)))
        web_png = _image_artifacts(answers)[0].binary
        route("grpc_web", t0, len(web_png))
        if _png_pixels(web_png).shape != shape:
            raise AssertionError("gRPC-Web image has the wrong shape")

        # 5. WebP by the accept list, or UNIMPLEMENTED without Pillow
        pillow = importlib.util.find_spec("PIL") is not None
        req = _generate_request(406)
        req.accept = "image/webp, image/png"
        t0 = time.perf_counter()
        if pillow:
            webp = _image_artifacts(list(generate(
                req, metadata=meta, timeout=600)), "image/webp")[0].binary
            wall = time.perf_counter() - t0
            # the servicer's own encode timer, read through /status
            with urllib.request.urlopen(urllib.request.Request(
                    base + "/status", headers=auth), timeout=60) as resp:
                timings = json.loads(resp.read())["timings"]
            emit({"phase": "http", "route": "webp", "wall_s": wall,
                  "bytes": len(webp), "pillow": True, "answer": "image/webp",
                  "encode_last_ms": timings["encode"]["last_ms"],
                  "generate_last_ms": timings["generate"]["last_ms"]})
            if webp[:4] != b"RIFF" or webp[8:12] != b"WEBP":
                raise AssertionError("the WebP artifact is not RIFF/WEBP")
        else:
            try:
                list(generate(req, metadata=meta, timeout=600))
                raise AssertionError("WebP answered without Pillow")
            except grpc.RpcError as e:
                if e.code() != grpc.StatusCode.UNIMPLEMENTED:
                    raise
            route("webp", t0, 0, pillow=False, answer="UNIMPLEMENTED")

        # 6. without the token: refused on both servers
        t0 = time.perf_counter()
        try:
            channel.unary_unary(
                "/gooseai.EnginesService/ListEngines",
                request_serializer=epb.ListEnginesRequest.SerializeToString,
                response_deserializer=epb.Engines.FromString)(
                    epb.ListEnginesRequest(), timeout=60)
            raise AssertionError("gRPC answered without the token")
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.UNAUTHENTICATED:
                raise
        refused = {}
        for name, path, body in (("status", "/status", None),
                                 ("rest", "/v1/generation/sd15/"
                                  "text-to-image", rest)):
            try:
                urllib.request.urlopen(urllib.request.Request(
                    base + path, data=body,
                    headers={"Content-Type": "application/json"}),
                    timeout=60)
                raise AssertionError(f"HTTP {path} answered without the "
                                     "token")
            except urllib.error.HTTPError as e:
                refused[name] = e.code
        route("no_token", t0, 0, grpc="UNAUTHENTICATED", http=refused)
        if refused != {"status": 401, "rest": 403}:
            raise AssertionError(f"HTTP without the token: {refused}")
        with urllib.request.urlopen(urllib.request.Request(
                base + "/status", headers=auth), timeout=60) as resp:
            status = json.loads(resp.read())
        disp = status["dispatcher"]
        emit({"phase": "http", "route": "status",
              "engines": status["engines"], "timings": status["timings"],
              **{k: disp[k] for k in ("batches", "coalesced_requests",
                                      "interleaved_chunks", "padded_rows",
                                      "watchdog")}})
        if [e["ready"] for e in status["engines"]] != [True, True]:
            raise AssertionError(f"/status engines {status['engines']}")
        channel.close()
    finally:
        if serving is not None:
            serving.stop(0)
        manager.dispatcher.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        del manager
        torch.cuda.empty_cache()


# the engines.yaml of phase_weights, as users write one: an !include of a
# template file, and an engine instantiating the template with params
WEIGHTS_TEMPLATES = """\
- id: smoke-sd-template
  abstract: true
  task: generate
  name: "{{name}}"
  model: {path: "{{ref}}"}
  options: {sampler: k_dpmpp_2m}
"""
WEIGHTS_ENGINES = """\
- !include smoke-templates.yaml
- id: loaded
  template: smoke-sd-template
  default: true
  params: {ref: gyre-smoke/sd15, name: SD 1.5 from disk}
"""


def phase_weights():
    """Full-width SD1.5 saved to disk and served from there (module
    docstring, phase 8). The checkpoint directory is removed at the end."""
    import os
    import shutil
    import tempfile

    import torch

    from gyre_tpu_torch import _build, server
    from gyre_tpu_torch.models.load import save_modelset
    from gyre_tpu_torch.models.modelset import random_preset
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline

    tmp = tempfile.mkdtemp(prefix="gyre-smoke-weights-")
    manager = None
    try:
        ms = random_preset("sd15", seed=0, dtype=torch.bfloat16,
                           device="cuda")
        export_bytes = 2 * ms.param_bytes()     # bf16 leaves written f32
        free = shutil.disk_usage(tmp).free
        if free < 2 * export_bytes:
            raise AssertionError(f"{free} bytes free under {tmp}, the f32 "
                                 f"export needs up to {export_bytes}")
        ckpt = os.path.join(tmp, "weights", "gyre-smoke--sd15")
        t0 = time.perf_counter()
        save_modelset(ms, ckpt)
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(ckpt) for f in files)
        with open(os.path.join(tmp, "smoke-templates.yaml"), "w") as fh:
            fh.write(WEIGHTS_TEMPLATES)
        with open(os.path.join(tmp, "engines.yaml"), "w") as fh:
            fh.write(WEIGHTS_ENGINES)
        manager = server.build_manager(server.parse_args(
            ["--enginecfg", os.path.join(tmp, "engines.yaml"),
             "--weight_root", os.path.join(tmp, "weights"),
             "--cache_path", os.path.join(tmp, "cache")]))
        t0 = time.perf_counter()
        manager.load_engines()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        status = manager.status()
        emit({"phase": "weights", "step": "load", "disk_free_bytes": free, "bytes_written": written,
              "save_s": save_s, "load_s": load_s, "status": status})
        if [s["weights"] for s in status] != ["real"]:
            raise AssertionError(f"engine status {status}")

        t0 = time.perf_counter()
        manager.prewarm()
        emit({"phase": "weights", "step": "prewarm",
              "state": manager.prewarm_state,
              "seconds": time.perf_counter() - t0})
        if manager.prewarm_state["state"] != "done":
            raise AssertionError(f"prewarm {manager.prewarm_state}")

        kw = dict(REQUEST, seeds=[7], output_dtype="uint8", chunk_steps=10,
                  stop_event=threading.Event())
        _build.reset_launches()
        loaded = manager.pipeline("loaded")(**kw)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        in_memory = UnifiedPipeline(ms, compute_dtype=torch.bfloat16)(**kw)
        diff = int((loaded.int() - in_memory.int()).abs().max())
        emit({"phase": "weights", "step": "image", "launches": launches,
              "max_abs_diff_uint8": diff,
              "equal": bool(torch.equal(loaded, in_memory))})
        if launches != EXPECTED_LAUNCHES:
            raise AssertionError(f"loaded engine: launch counts {launches} "
                                 f"!= {EXPECTED_LAUNCHES}")
        if tuple(loaded.shape) != (1, REQUEST["height"], REQUEST["width"],
                                   3) or diff > 1:
            raise AssertionError(f"loaded engine's image {tuple(loaded.shape)}"
                                 f" differs from the in-memory one by {diff}")
        del ms, in_memory
        torch.cuda.empty_cache()

        phase_grpc(manager, "loaded", seeds=(300,), phase="weights_grpc")
        t0 = time.perf_counter()
        batch = manager.suggest_max_batch("loaded", 512, 512)
        emit({"phase": "weights", "step": "suggest_max_batch",
              "height": 512, "width": 512, "max_batch": batch,
              "bytes_per_image": manager._probe_bytes_per_image(
                  "loaded", 512, 512),
              "seconds": time.perf_counter() - t0})
    finally:
        if manager is not None:
            manager.dispatcher.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# kernel-name substrings of csrc/'s kernels (and of earlier trees' K2a)
PORT_KERNEL_NAMES = ("flash", "gn_stats", "gn_partial", "gn_finalize",
                     "gn_silu_conv3x3")


def phase_profile(out_dir: str = "out"):
    """(``--profile`` only.) The chip_smoke configuration's batch-1 call:
    host-clock latency with the kernels against the plain versions swapped
    in (order plain, kernel, kernel, plain; median of 3 calls each), then a
    torch.profiler trace of one call with the kernels, its device time by
    kernel written to ``<out_dir>/profile_b1.txt``, beside the host
    numbers (``_call``) of that call and of one untraced call, its count
    of device operations, its copy kernels and csrc/'s kernels; then the
    same numbers (without the file) for a request with one ControlNet at
    the prompt and hint priorities and with the T2I adapter."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gyre_tpu_torch.models.modelset import random_preset
    from gyre_tpu_torch.ops import attention as A
    from gyre_tpu_torch.ops import fused_norm_conv as FC
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline

    ms = random_preset("sd15", seed=0, dtype=torch.bfloat16, device="cuda")
    pipe = UnifiedPipeline(ms, compute_dtype=torch.bfloat16)
    kw = dict(REQUEST, output_dtype="uint8", chunk_steps=10,
              stop_event=threading.Event())

    def call(seed=1):
        return _call(pipe, [seed], kw)[1]["wall_s"]

    kernel_fns = (A.attention, FC.gn_silu_conv3x3)

    def plain_attention(q, k, v, mask=None, scale=None):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        if mask is not None:
            return kernel_fns[0](q, k, v, mask=mask, scale=scale)
        return A.attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), scale).transpose(1, 2)

    def use(plain: bool):
        A.attention = plain_attention if plain else kernel_fns[0]
        FC.gn_silu_conv3x3 = (FC.gn_silu_conv3x3_plain if plain
                              else kernel_fns[1])

    ab = {"plain": [], "kernels": []}
    try:
        for plain in (True, False, False, True):
            use(plain)
            call()                                           # warm-up
            ab["plain" if plain else "kernels"].append(
                sorted(call(s) for s in (2, 3, 4))[1])
    finally:
        use(False)
    emit({"phase": "profile", "batch1_s": ab})

    untraced = _call(pipe, [5], kw)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = _call(pipe, [5], kw)[1]
    wall = traced["wall_s"]
    # host calls that wait on the card (cuda{Stream,Device,Event}
    # Synchronize), _call's own one at the end included
    waits = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and "Synchronize" in e.name)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name: dict[str, list] = {}
    for e in events:
        slot = by_name.setdefault(e.name, [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e3
        slot[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # device copies (casts, layout copies, memcpy) and the kernels of
    # csrc/ by name, with their counts in the call
    copies = [sum(v[i] for n, v in by_name.items() if "copy" in n.lower())
              for i in (0, 1)]
    port = {n[:90]: v for n, v in by_name.items()
            if any(k in n for k in PORT_KERNEL_NAMES)}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_b1.txt"), "w") as fh:
        fh.write(f"wall {wall:.4f} s, device busy {busy_us / 1e6:.4f} s\n")
        for name, (msec, n) in top:
            fh.write(f"{msec:10.3f} ms {n:6d}  {name}\n")
    emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy_us / 1e6,
          "host_untraced": untraced, "host_traced": traced,
          "host_waits_on_card": waits, "device_ops": len(events),
          "copies": {"ms": copies[0], "count": copies[1]},
          "port_kernels": port,
          "top_kernels_ms": [[name[:90], msec, n]
                             for name, (msec, n) in top[:20]]})

    # hinted requests (phase 5d's models and cases): host numbers untraced
    # and traced beside the card's busy time, to tell what a hint adds on
    # the host from what it adds on the card
    _, _, mask, hints = _hint_kit()
    for name in ("controlnet_prompt", "controlnet_hint", "t2i_balanced"):
        hkw = dict(kw, hints=hints(HINT_CASES[name][0], mask))
        _call(pipe, [5], hkw)                                # warm-up
        untraced = _call(pipe, [5], hkw)[1]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = _call(pipe, [5], hkw)[1]
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        port = {}
        for e in events:
            if any(k in e.name for k in PORT_KERNEL_NAMES):
                slot = port.setdefault(e.name[:90], [0.0, 0])
                slot[0] += e.time_range.elapsed_us() / 1e3
                slot[1] += 1
        emit({"phase": "profile", "case": name, "host_untraced": untraced,
              "host_traced": traced, "device_busy_s": sum(
                  e.time_range.elapsed_us() for e in events) / 1e6,
              "device_ops": len(events), "port_kernels": port})


KERNEL_TABLE = [
    ("flash_attention", "gyre_tpu_torch/csrc/flash_attention.cu",
     "gyre_tpu/ops/attention.py:49"),
    ("gn_stats", "gyre_tpu_torch/csrc/gn_stats.cu",
     "gyre_tpu/ops/fused_norm_conv.py:42"),
    ("gn_silu_conv3x3", "gyre_tpu_torch/csrc/gn_silu_conv3x3.cu",
     "gyre_tpu/ops/fused_norm_conv.py:63"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import gyre_tpu_torch

    gyre_tpu_torch.set_matmul_precision()
    phase_env()
    phase_build()
    if "--profile" in sys.argv[1:]:
        phase_profile()
        return 0
    for name, shapes in (("flash_attention", ATTN_SHAPES),
                         ("gn_silu_conv3x3", CONV_SHAPES)):
        if sum(s[-1] for s in shapes) != EXPECTED_LAUNCHES[name]:
            raise AssertionError(f"{name}: phase-3 launches per call do "
                                 "not add up to EXPECTED_LAUNCHES")
    kernels = phase_kernels()
    launches = phase_pipeline()
    # what each phase leaves allocated on the card, once its engines are
    # collected: an EngineManager is in a reference cycle (its hintsets hold
    # its bound loader), so only the cycle collector frees its weights
    for phase in (phase_samplers, phase_modes, phase_adapters, phase_hints,
                  phase_sd2, phase_sdxl, phase_serve, phase_http,
                  phase_weights):
        phase()
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": phase.__name__.removeprefix("phase_"),
              "allocated_after_bytes": torch.cuda.memory_allocated()})
    # ms, plain_ms, library_ms, bound_ms: sums over the phase-3 shapes of
    # the median times and of the bounds; the *_per_call keys weight each
    # shape by its launches in one batch-1 call; max_abs_err: the largest
    # absolute error over those shapes; bound_by: what bounds the most of
    # the summed bound. The modes phase's shapes are summed the same way
    # on a line of their own, so that the kernels line covers the shapes
    # it covered before them.
    def summary(rs):
        by = {k: sum(r["bound_ms"] for r in rs if r["bound_by"] == k)
              for k in ("bytes", "operations")}
        return {"max_abs_err": max(r["max_abs_err"] for r in rs),
                **{k: sum(r[k] for r in rs)
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                "bound_by": max(by, key=by.get)}

    rows, mode_rows, cn_rows, c5_rows = [], [], [], []
    for name, source, replaces in KERNEL_TABLE:
        rs = [r for r in kernels[name] if not r.get("modes") and
              not r.get("controlnet") and not r.get("c5")]
        mode_rs = [r for r in kernels[name] if r.get("modes")]
        cn_rs = [r for r in kernels[name] if r.get("controlnet")]
        c5_rs = [r for r in kernels[name] if r.get("c5")]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **summary(rs),
            **{f"{k}_per_call": sum(r[k] * r["launches_per_call"]
                                    for r in rs)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")}})
        mode_rows.append({"name": name, "shapes": len(mode_rs),
                          **summary(mode_rs)})
        cn_rows.append({"name": name, "shapes": len(cn_rs),
                        **summary(cn_rs)})
        c5_rows.append({"name": name, "shapes": len(c5_rs),
                        **summary(c5_rs)})
    emit({"mode_shapes": mode_rows})
    emit({"controlnet_shapes": cn_rows})
    emit({"c5_shapes": c5_rows})
    emit({"c5_paths": {name: _path_sums(kernels, parts)
                       for name, parts in _c5_paths().items()}})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
