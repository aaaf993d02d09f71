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
               channels), summed on a "c5_shapes" line; and at the
               adjust phase's (_adjust_shapes: DPT-Large's
               self-attention [1, T, 16, 64] at T = 257, 577, 1025, and
               the SD1.5 UNet's one-row shapes of cfg_sequential that no
               other row has), summed on an "adjust_shapes" line; and
               at the hinters phase's (_hinter_shapes: UniFormer-S's
               self-attention on a 512² image, [1, 1024, 5, 64] and
               [1, 256, 8, 64]), summed on a "hinter_shapes" line; and
               at the diffusion upscalers phase's (_upscaler_shapes: the
               x4 UNet's head dims 8, 16 and 32 and its 64-256 channels
               at 2 to 8 channels a group, Co = 64 among them; the
               k-UNet's head dim 64; ToMe's merged token counts 3072, 768,
               192 and 48), summed on an "upscaler_shapes" line; and at
               the clip phase's (_clip_shapes: ViT-L/14's attention on 4
               guidance views and a safety batch of 8, the style
               adapter's [1, 265, 8, 128], the UNet's cross-attention
               against 85 tokens, the VAE decoder on two 28² latent
               cutouts: its mid block over 784 tokens and its convs at 28²
               to 224²), summed on a "clip_shapes" line; then one row each
               for K1 and K2 of a forward + backward through their
               recompute Functions against the plain twins' autograd at
               the cond stem's 64² shapes, timed, the gradients within
               GRAD_ROW_BOUND
  4. pipeline  UnifiedPipeline on full-width SD1.5 (random weights from a
               seed): 512x512, 20 steps k_dpmpp_2m, CFG 7.5 (parallel),
               bf16, chunk_steps=10 with a stop_event, uint8 on the device.
               Launch counts of one batch-1 call, batch-1 p50 of 10 calls
               with each call's host numbers (time to queue its work,
               the queuing thread's CPU time and preemptions), batch-8
               images/s, peak memory and what phase 3 left allocated
  4b. pool     the device mesh (parallel/mesh.py, pool.py) on the card:
               SD1.5 at 512² as phase 4, batch 8 through a pool of two
               replicas on cuda:0 (4 + 4 rows, a host thread each)
               against one replica on each group's rows (uint8 within
               POOL_LEVELS) and on all 8 (within BATCH_LEVELS), both
               walls, launches 2 x 641 / 908 / 908, and tp = 2 with both
               shards on cuda:0 at batch 1 and 8 against tp = 1 (within
               TP_LEVELS, walls, K1 launches 2 x 32 a UNet call + 1: each
               shard launches); with more than one visible GPU a pool
               over all of them too. Its K1 shapes at H/2 heads are phase
               3's rows tagged pool (the "pool_shapes" line). Then A2:
               the host cost of a threefry draw at [8, 128, 128, 4] on the
               card against the per-seed torch.Generator draw it replaced
               (kept here as ``_generator_draw``), and the batch-1 p50
               with each, alternating
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
  5g. adjust   cfg_sequential on SD1.5 at batch 1 (two UNet calls of one
               row a model call: launches 2 x 20 x 32 + 1 / 44 + 28, its
               image within BF16_BOUND of the parallel one, both walls);
               a chain of every pure adjustment at 512x512 on the card
               against the same chain on the CPU (1e-4; canny, palletize
               and quantize by the share of values they flip, the shuffle
               with one flow exactly); then DPT-Large written to disk in
               the Intel/dpt-large layout (random, seed 0, bf16: hidden
               1024, 24 layers, 16 heads, ~343 M parameters) and ZoeD_N
               over it (the trunk under core.core.), served by
               server.serve as midas-depth and zoe-depth engines beside
               SD1.5 with a hintset of SD1.5-width ControlNets (depth,
               canny, color, shuffle): weights "real" at full width, each
               estimate's launches (24 K1 at [1, 577, 16, 64]), wall and
               map, the DPT's against its f32 on the CPU; then client.py's
               own request builders (read from client.py with the port's
               stubs) over gRPC: --mask_from_image_alpha (the kept pixels
               equal the init image), --hint canny (the plain hinted
               request), --hint_from_image depth / canny / color /
               shuffle (launches 921 / 1308, depth + 24 K1; the depth one
               within 1 level of the same request in-process), requests
               to each depth engine; the plain and depth-hinted walls
  5h. hinters  the hinter engines of config/engines/utility.yaml at their
               published widths (random, seed 0, drawn on the card,
               written to disk in the published layouts in bf16): HED,
               informative drawings, DexiNed, the OpenPose body CPM,
               UniFormer-S (upernet_global_small, 150 classes), BAE
               (EfficientNet-B5) and M-LSD large, served by server.serve
               beside SD1.5 with a hintset of SD1.5-width ControlNets:
               each "real" and ready, its parameters, bytes and load
               seconds; one estimate of the 512² image each (the median
               wall of 3, peak memory, launches: 11 K1 for UniFormer,
               none for the others), a traced HED and UniFormer estimate
               (busy share, top device operations, no FFT or gemv); the
               card's bf16 against the same weights in f32 on the CPU at
               256² (HINTER_MAP_BOUND, HINTER_MAP_BOUNDS,
               HINTER_CLASS_SHARE; pose's and M-LSD's maps, and their
               decodes of the CPU's maps on the card equal to the CPU's,
               also with the maps scaled to pass the thresholds); then
               client.py's own request builders over gRPC:
               --hint_from_image hed / sketch / segmentation / openpose /
               keypose / normal (launches 921 / 1308 / 1308, segmentation
               + 11 K1) against the plain hinted request, a request to
               each engine (its PNG within one level of its in-process
               map), and the hed-hinted image within 1 level of the same
               request in-process
  5i. upscalers the D3b and D4 engines of config/engines/utility.yaml at
               their published widths (random, seed 0, drawn on the card,
               written to disk in the published layouts in bf16):
               RealESRGAN_x4plus (23 RRDB), SwinIR-M x4 classical, HAT-M
               x4 and InSPyReNet-SwinB (embed 128, depths 2/2/18/2,
               window 12, decoder depth 64), served by server.serve beside
               SD1.5 with a depth ControlNet hintset: each "real" and
               ready, its parameters,
               bytes and load seconds; background removal at 512²
               (unscaled), 1920x1536 (scaled) and 2816x2304 (scaled,
               guided filter), ESRGAN on a 256² RGBA image (16 tiles of
               128², each 4x4 cell of its output against the model run
               untiled, ESRGAN_TILE_CELL_BOUND; the alpha's shape) and
               SwinIR and HAT on a 128² image, each with its wall, peak
               memory and launches (none), the background removals'
               device busy share; the card's models against the same
               weights in f32 on the CPU (UPSCALER_CPU_SIZES: InSPyReNet's
               logits and ESRGAN's image in bf16 within
               UPSCALER_BF16_BOUND, SwinIR and HAT in f32 on both sides
               within UPSCALER_F32_BOUND); the background-removal engine
               at BG_ENGINE_MAX_RES on a BG_ENGINE_SIZE image (scaled,
               guided filter), its RGBA against a CPU engine's in f32
               over the same checkpoint (BG_ENGINE_ALPHA_BOUND); then
               client.py's own request
               builders over gRPC: -e esrgan-x4 -i and -e
               background-removal -i (each PNG within one level of the
               engine's in-process image, no launches), --hint_from_image
               nobg:depth: (background removal, the depth hint, the mask
               reapplied; launches 921 / 1308 / 1308, within 1 level of
               the same chain and request in-process)
  5j. diffusion_upscalers  the D4b engines of config/engines/utility.yaml
               at full width (random, seed 0, drawn on the card, written
               to disk: the x4 (UNet 64/128/256/256, 7 channels, class-
               embedded noise level; CLIP ViT-L; the 3-level VAE) and the
               x2 (the k-UNet 384/768/768/1536, 4 resnets a block; CLIP
               ViT-L; the SD VAE) as diffusers directories in f32,
               CodeFormer (nf 64, 9 layers of 512, 1024 codes) in the
               codeformer.pth layout in bf16), served by server.serve
               beside two SD1.5 engines, one with the engine option
               tome_ratio 0.5: each "real" and ready; the x4 on a 128²
               image (512² out, 20 steps DPM++ 2M, noise level 20), the
               x2 on a 512² image (1024² out, 30 steps k_euler), CodeFormer
               at 512² and at 600x440 (resized to 512² and back), each
               with its launches against those walked from the configs
               (_upscaler_paths: x4 K1 32 x 20 + 1, K2a/K2b 44 x 20 + 22;
               x2 K1 32 x 30 + 2, K2a/K2b 48; CodeFormer none), wall and
               peak memory; the x4 and x2 in bf16 against the same
               checkpoints in f32 on the CPU with the same noise
               (DIFFUSION_CPU_SIZES, DIFFUSION_CPU_STEPS,
               DIFFUSION_BF16_BOUND), CodeFormer in
               f32 on both (FACE_INDEX_SHARE, FACE_F32_MEAN_BOUND); the
               SD1.5 request of phase 4 under ToMe (launches 641 / 908 /
               908, an image that differs from the unmerged one, its
               10-step-chunked run equal in every bit, both walls); then
               client.py's requests over gRPC (-e upscaler-x4 / upscaler-
               x2 / codeformer -i, and -e sd15-tome), each with its
               launches and within one level of the same work in-process,
               and ListEngines' upscale group with both upscalers ready
  5k. clip     CLIP guidance, the style hint and the safety checker on
               full-width SD1.5 (random, seed 0, bf16) served by
               server.serve with a `clip:` model, a style hintset and a
               `safety_checker:` key: a CLIPModel ViT-L/14 (text and
               vision, projection 768) with its config.json and
               TencentARC's style adapter (1024 wide, 3 layers, 8 tokens,
               context 768), random, written to disk and loaded through
               the strict loaders ("real"); in-process at 512², 20 steps,
               10-step chunks: guided (scale 0.5, 2 approx + 2 VAE
               cutouts), "mixed", no_cutouts "vae", guided on a LoRA-
               adapted view, and the style hint, each with its launches
               exactly as walked from the configs (_clip_paths), wall and
               peak memory; the guided request traced (device busy
               share); the guidance loss's gradient through the kernels
               against the plain twins' on the same bf16 weights and
               input (CLIP_GRAD_BOUNDS, one for each sigma), and a
               deliberately cut graph's (must exceed it); a small guided
               request in bf16 against f32 on the CPU over the same
               weights, noise and crops (CLIP_CPU_BOUND); over gRPC, client.py's --guidance and
               --hint style requests (launches, within 1 level of the
               in-process image); then the batch-8 request's images, a
               ViT-L checker (17 concepts, 3 special-care) made to flag
               images 0 and 3, written in diffusers' layout: its scores
               on the card against the file's in f32 on the CPU
               (SAFETY_SCORE_BOUND; the flags equal where the margin
               exceeds it; 24 K1 a check), and the request under
               --nsfw_behaviour flag (FILTER on those two, the others
               as unchecked) and block (those two black)
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
               launches those of the two stages; the same chain with an
               ESRGAN x4 stage after the refiner (random, 23 blocks, tiled):
               one 4096x4096 image, the same launches (ESRGAN launches
               none), within 1 level of the engine's pipeline applied
               in-process to the refined image; the load seconds, each
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
card. At the end it prints the sums of the mode, ControlNet, C5, adjust,
hinter, upscaler, clip and pool rows, the "c5_paths", "upscaler_paths" and
"clip_paths" lines (each sd2/sdxl request's, each x4, x2 and ToMe
request's, and each clip phase request's, launches and the sums over them
of phase 3's kernel, plain, library and bound times), then,
before the last line, the kernels table as one JSON object; the last line
is {"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero; without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
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
    out, ref = out.detach().float(), ref.detach().float()
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


def _unet_call_shapes(cfg, size: int, b: int = 2, tk: int = 77):
    """(K1 launches, K2 launches) of one UNet call at latent size
    ``size``², walked from the port's spec tree of ``cfg``: one entry a
    launch, K1 as (B, H, Tq, Tk, d), K2a/K2b as (B, H=W, C, Co, eps). A
    transformer block is a self and a cross (``tk`` context tokens: 77, 85
    with a style hint's 8) attention, a resnet its two fused convs."""
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
                                  (b, heads, hw * hw, tk, d)])

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


def _vae_call_shapes(cfg, size: int, part: str, b: int = 1):
    """(K1 launches, K2 launches) of one VAE call of ``b`` rows, as
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
            convs.extend([(b, hw, c, co, 1e-6), (b, hw, co, co, 1e-6)])

    def mid(hw):
        c = specs["mid"]["attn"]["q"]["w"].shape[0]
        resnets([specs["mid"]["res1"], specs["mid"]["res2"]], hw)
        attns.append((b, 1, hw * hw, hw * hw, c))

    if part == "encoder":
        for lvl, blk in enumerate(specs["down"]):
            resnets(blk["resnets"], size >> lvl)
        mid(size >> (n - 1))
    else:
        mid(size)
        for i, blk in enumerate(specs["up"]):
            resnets(blk["resnets"], size << i)
    return attns, convs


def _launches(parts, calls=None):
    """Expected launches of a request of _c5_paths (or of another table of
    ``calls``, _c5_calls by default): parts [(count, call name)]."""
    calls = calls or _c5_calls()
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


def _path_sums(kernels, parts, calls=None):
    """Per kernel, a request's launches and the sums over its launches of
    phase 3's median times (kernel, plain, library) and bounds, each
    launch priced at its shape's row, whichever set the row is in; the
    calls of _c5_calls unless ``calls`` is given."""
    calls = calls or _c5_calls()
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


# the depth engine's sizes: 384 (DPT-Large's native grid, the engine's
# default) and the other square sizes an engine's `size:` may give it
DPT_SIZES = (256, 384, 512)


def _adjust_shapes():
    """(K1 rows, K2a + K2b rows) of the adjust phase that phase 3's other
    rows lack: DPT-Large's self-attention at each of DPT_SIZES (one image,
    16 heads of 64, T = (size / 16)² + 1: 577 at 384, odd and no multiple
    of K1's tiles), and SD1.5's UNet at one row (cfg_sequential runs each
    CFG half as a call of its own): K1 rows (name, B, H, Tq, Tk, d), conv
    rows (name, B, H=W, C, Co, eps)."""
    from gyre_tpu_torch.models import configs

    cn_attn, cn_conv = _controlnet_shapes()
    c5_attn, c5_conv = _c5_shapes()
    seen_attn = {r[1:6] for r in ATTN_SHAPES + MODE_ATTN_SHAPES + cn_attn +
                 c5_attn}
    seen_conv = {r[1:6] for r in CONV_SHAPES + MODE_CONV_SHAPES + cn_conv +
                 c5_conv}
    attns = [(f"dpt_self_{s}", 1, 16, (s // 16) ** 2 + 1,
              (s // 16) ** 2 + 1, 64) for s in DPT_SIZES]
    convs = []
    a, c = _unet_call_shapes(configs.SD15.unet, 64, b=1)
    for dims in a:
        if dims not in seen_attn:
            seen_attn.add(dims)
            kind = "cross" if dims[3] == 77 else "self"
            attns.append((f"seq_{kind}_{dims[2]}", *dims))
    for dims in c:
        if dims not in seen_conv:
            seen_conv.add(dims)
            convs.append((f"seq_{dims[1]}_{dims[2]}_{dims[3]}", *dims))
    return attns, convs


# the hinters phase: each engine's estimate of the 512² test image on the
# card; its bf16 maps against the same weights in f32 on the CPU at 256²
# (the CPU's time); bounds: max abs diff over max |f32| for the continuous
# maps (one bf16 rounding a layer through 13-50 layers of a random net;
# a fault gives errors of order 1), and the share of pixels that keep
# their class for the segmentation (near-ties of random logits flip).
# The line-art net's InstanceNorm holds each of its 22 convs at unit
# scale, so every layer's rounding stays relative to the end (0.0206 on
# an H100 80GB HBM3 at 700.00 W, PERF.md): it is held to 3e-2
HINTER_SIZE = 512
HINTER_CPU_SIZE = 256
HINTER_MAP_BOUND = 2e-2
HINTER_MAP_BOUNDS = {"lineart": 3e-2}
HINTER_CLASS_SHARE = 0.99

# the upscalers phase: background removal at 512² (unscaled), a non-square
# image whose long side lies between 1280 and 2560 (scaled, no filter) and
# one past 2560 (scaled, guided filter); the upscalers' inputs; the
# bf16-against-f32 sizes; the bounds (max |card - CPU| / max |CPU|)
BG_SIZES = {"unscaled": (512, 512), "scaled": (1920, 1536),
            "guided": (2816, 2304)}
ESRGAN_SIZE = 256
SR_SIZE = 128
UPSCALER_CPU_SIZES = {"background-removal": 256, "esrgan-x4": 64,
                      "swinir-x4": 48, "hat-x4": 48}
UPSCALER_BF16_BOUND = 2e-2      # InSPyReNet's logits, ESRGAN's image
UPSCALER_F32_BOUND = 1e-3       # SwinIR, HAT: f32 on both sides
# the background-removal engine at a small max_res on an image past twice
# it (so the resizes and the guided filter run): the card's (bf16) RGBA
# against a CPU engine's in f32 over the same checkpoint. RGB equal; the
# alpha, in [0, 1], within the bound: bf16 rounding moves it by ~1e-3-1e-2
# (the logits' error through the sigmoid, the min-max stretch and the
# 1.25 of (map - 0.2) / 0.8), where a missed pad, resize or filter moves it
# by the map's own contrast (~0.1-1)
BG_ENGINE_MAX_RES = 128
BG_ENGINE_SIZE = (320, 288)
BG_ENGINE_ALPHA_BOUND = 5e-2
# ESRGAN tiled against untiled, the mean |difference| of each of the 4x4
# cells of the output: a tile sees 16 px of context where the 23-block
# RRDB's receptive field is ~350 px, so seams differ (0.0028 mean, 0.19 at
# most, at random weights in an f32 CPU rehearsal); a misplaced or
# misweighted tile moves its cell by the image's own spread (~0.1)
ESRGAN_TILE_CELL_BOUND = 2e-2


def _hinter_shapes():
    """K1 rows of the hinters phase that phase 3's other rows lack:
    UniFormer-S's global self-attention on one 512² image, stage 3 at 1/16
    (T = 1024, 5 heads of 64) and stage 4 at 1/32 (T = 256, 8 heads):
    (name, B, H, Tq, Tk, d)."""
    from gyre_tpu_torch.models import uniformer

    cfg = uniformer.UNIFORMER_SMALL
    return [(f"uniformer_s{si + 1}_{(HINTER_SIZE // stride) ** 2}", 1,
             cfg.embed_dim[si] // cfg.head_dim,
             (HINTER_SIZE // stride) ** 2, (HINTER_SIZE // stride) ** 2,
             cfg.head_dim) for si, stride in ((2, 16), (3, 32))]


# the diffusion upscalers phase: the x4 upscaler on a 128² image (its
# latents are the image's size; 512² out, 20 steps of DPM++ 2M at noise
# level 20), the x2 on a 512² image (64² latents, 2x: 1024² out, 30 steps
# of k_euler), CodeFormer at its 512² and at a non-square size (resized to
# 512² and back), ToMe at ratio 0.5 on the SD1.5 request of phase 4
X4_SIZE = 128
X2_SIZE = 512
X4_STEPS, X2_STEPS = 20, 30
FACE_OTHER_SIZE = (600, 440)
TOME_RATIO = 0.5
# the card's upscalers (bf16) against the same checkpoints in f32 on the
# CPU, with the same noise (the port draws it on the CPU for any device),
# on small inputs (x4 32² -> 128², x2 64² -> 128²), the x4 at its 20 steps,
# the x2 at 8 of k_euler (30 of its f32 k-UNet take the CPU a minute):
# max |card - CPU| over the [0, 1] image. One bf16 rounding a layer
# through 8-20 UNet calls of random nets, each step's error carried into
# the next (0.0072 and 0.0080 at 20 and 30 steps on an H100 80GB HBM3 at
# 700.00 W, PERF.md); a fault (a wrong level, channel or sigma) moves the
# image by its own spread (~0.1-0.5)
DIFFUSION_CPU_SIZES = {"upscaler-x4": 32, "upscaler-x2": 64}
DIFFUSION_CPU_STEPS = {"upscaler-x4": X4_STEPS, "upscaler-x2": 8}
DIFFUSION_BF16_BOUND = 5e-2
# CodeFormer runs in f32 on both sides (TF32 off): the share of its 256
# codebook indices that agree (a near-tie of random logits may flip one
# token, which repaints a 32x32 block), and the image's mean |diff|
FACE_INDEX_SHARE = 0.99
FACE_F32_MEAN_BOUND = 2e-3


def _kunet_call_shapes(cfg, size: int, b: int = 2):
    """(K1 launches, K2 launches) of one k-UNet call at latent size
    ``size``², walked from the port's spec tree as _unet_call_shapes: a
    KAttentionBlock is a self-attention where it has one and a
    cross-attention against 77 tokens; its convs are plain (no K2)."""
    from gyre_tpu_torch.models import kunet

    specs = kunet.param_specs(cfg)
    attns = []

    def block(blk, hw):
        for att in blk.get("attentions", []):
            c = att["attn2"]["q"]["w"].shape[0]
            heads = max(1, c // cfg.head_dim)
            if "attn1" in att:
                attns.append((b, heads, hw * hw, hw * hw, c // heads))
            attns.append((b, heads, hw * hw, 77, c // heads))

    last = cfg.levels - 1
    for li, blk in enumerate(specs["down"]):
        block(blk, size >> li)
    for li, blk in enumerate(specs["up"]):
        block(blk, size >> (last - li))
    return attns, []


def _tome_call_shapes(cfg, size: int, ratio: float, b: int = 2):
    """_unet_call_shapes under ToMe: each self-attention over T - r merged
    tokens (ops/tome.py's r at ``ratio``)."""
    from gyre_tpu_torch.ops import tome

    attns, convs = _unet_call_shapes(cfg, size, b)
    merged = []
    for bb, h, tq, tk, d in attns:
        if tk == tq:
            tq = tk = tq - tome.merge_count(tq, ratio)
        merged.append((bb, h, tq, tk, d))
    return merged, convs


def _upscaler_calls():
    """The model calls of the diffusion upscalers phase, by name: (K1, K2)
    shapes of one call, as _c5_calls. The x4's UNet at X4_SIZE latents and
    its 3-level VAE's decode; the x2's SD VAE encode of the X2_SIZE image,
    its k-UNet at twice the latents and the decode; SD1.5's UNet under
    ToMe at 64 latents and its decode; parallel CFG: 2 rows a UNet call."""
    from gyre_tpu_torch.models import configs
    from gyre_tpu_torch.pipeline import diffusion_upscaler as du

    x4, x2 = du.X4_CONFIG, du.X2_CONFIG
    lat2 = 2 * X2_SIZE // 8
    return {
        "x4_unet": _unet_call_shapes(x4.unet, X4_SIZE),
        "x4_decode": _vae_call_shapes(x4.vae, X4_SIZE, "decoder"),
        "x2_encode": _vae_call_shapes(x2.vae, X2_SIZE, "encoder"),
        "x2_unet": _kunet_call_shapes(x2.unet, lat2),
        "x2_decode": _vae_call_shapes(x2.vae, lat2, "decoder"),
        "tome_unet": _tome_call_shapes(configs.SD15.unet, 64, TOME_RATIO),
        "sd15_decode": _vae_call_shapes(configs.SD15.vae, 64, "decoder"),
    }


def _upscaler_paths():
    """The requests of the diffusion upscalers phase as model calls, as
    _c5_paths: one model call a step (k_euler and DPM++ 2M)."""
    return {"upscaler_x4": [(X4_STEPS, "x4_unet"), (1, "x4_decode")],
            "upscaler_x2": [(1, "x2_encode"), (X2_STEPS, "x2_unet"),
                            (1, "x2_decode")],
            "sd15_tome": [(STEPS, "tome_unet"), (1, "sd15_decode")]}


def _upscaler_shapes():
    """(K1 rows, K2a + K2b rows) of the diffusion upscalers phase that
    phase 3's other rows lack: the x4 UNet's head dims 8, 16 and 32 and
    its 64-256 channels, its VAE's mid block (one head of 512 over
    X4_SIZE² tokens) and its 128-512 channels, the k-UNet's head dim 64
    and ToMe's merged token counts."""
    cn_attn, cn_conv = _controlnet_shapes()
    c5_attn, c5_conv = _c5_shapes()
    adj_attn, adj_conv = _adjust_shapes()
    seen_attn = {r[1:6] for r in ATTN_SHAPES + MODE_ATTN_SHAPES + cn_attn +
                 c5_attn + adj_attn + _hinter_shapes()}
    seen_conv = {r[1:6] for r in CONV_SHAPES + MODE_CONV_SHAPES + cn_conv +
                 c5_conv + adj_conv}
    attns, convs = [], []
    for call, (a, c) in _upscaler_calls().items():
        for dims in a:
            if dims not in seen_attn:
                seen_attn.add(dims)
                kind = "cross" if dims[3] == 77 else "self"
                attns.append((f"{call}_{kind}_{dims[2]}_d{dims[4]}", *dims))
        for dims in c:
            if dims not in seen_conv:
                seen_conv.add(dims)
                convs.append((f"{call}_{dims[1]}_{dims[2]}_{dims[3]}",
                              *dims))
    return attns, convs


# the clip phase: CLIP guidance at scale 0.5 (2 approx and 2 VAE cutouts,
# "guided") on the phase-4 request in 10-step chunks; the style hint's
# adapter at its published widths; the safety checker on a batch of 8
CLIP_SCALE = 0.5
CLIP_CHUNK = 10
CLIP_SAFETY_BATCH = 8
CLIP_SAFETY_FLAGGED = (0, 3)
STYLE_TOKENS = 8


def _vision_call(cfg, b: int):
    """(K1 launches, no K2) of one CLIP vision tower call on ``b`` images:
    a non-causal attention a layer at T = (S / patch)² + 1."""
    t = (cfg.image_size // cfg.patch_size) ** 2 + 1
    return [(b, cfg.num_heads, t, t, cfg.hidden_size // cfg.num_heads)
            ] * cfg.num_layers, []


def _clip_calls():
    """The model calls of the clip phase, by name: (K1, K2) shapes of one
    call. SD1.5 at 512² (64 latents): the CFG UNet (2 rows), the guided
    step's cond stem (1 row), the UNet under a style hint (85 context
    tokens) and the decode; the VAE decoder on 2 latent cutouts of 28²
    (one with no_cutouts "vae"); ViT-L/14's tower on 4 views (2 approx +
    2 VAE cutouts), on 1 (a style image, a whole-image view) and on the
    safety check's batch; the style adapter's 3 layers at 257 + 8
    tokens, 8 heads of 128."""
    from gyre_tpu_torch.models import clip, configs

    sd = configs.SD15
    lat = max(clip.CLIP_VISION_L.image_size // 8, 8)
    d = 1024 // 8
    t = (clip.CLIP_VISION_L.image_size //
         clip.CLIP_VISION_L.patch_size) ** 2 + 1 + STYLE_TOKENS
    return {
        "sd15_unet": _unet_call_shapes(sd.unet, 64),
        "sd15_stem": _unet_call_shapes(sd.unet, 64, b=1),
        "sd15_style_unet": _unet_call_shapes(sd.unet, 64,
                                             tk=77 + STYLE_TOKENS),
        "sd15_decode": _vae_call_shapes(sd.vae, 64, "decoder"),
        "cut_decode_2": _vae_call_shapes(sd.vae, lat, "decoder", b=2),
        "cut_decode_1": _vae_call_shapes(sd.vae, lat, "decoder", b=1),
        "vision_4": _vision_call(clip.CLIP_VISION_L, 4),
        "vision_1": _vision_call(clip.CLIP_VISION_L, 1),
        "vision_safety": _vision_call(clip.CLIP_VISION_L,
                                      CLIP_SAFETY_BATCH),
        "style_adapter": ([(1, 8, t, t, d)] * 3, []),
    }


def _clip_paths():
    """The clip phase's requests as model calls: {name: [(count, call)]}.
    A guided step runs the CFG UNet, the cond stem (the backward
    recomputes plain, launching nothing), the cutouts' decode and the
    tower; a 20-step request in 10-step chunks adds the decode of its
    image and one unguided loss after its first chunk (the CFG UNet, the
    cutouts, the tower); "mixed" takes the gradient through the CFG UNet
    itself (no stem)."""
    def guided(step, loss):
        return [(STEPS, c) for c in step] + [(1, "sd15_decode")] + \
            [(STEPS // CLIP_CHUNK - 1, c) for c in loss]

    cut4 = ["cut_decode_2", "vision_4"]
    cut1 = ["cut_decode_1", "vision_1"]
    return {
        "guided": guided(["sd15_unet", "sd15_stem"] + cut4,
                         ["sd15_unet"] + cut4),
        "mixed": guided(["sd15_unet"] + cut4, ["sd15_unet"] + cut4),
        "no_cutouts_vae": guided(["sd15_unet", "sd15_stem"] + cut1,
                                 ["sd15_unet"] + cut1),
        "lora_guided": guided(["sd15_unet", "sd15_stem"] + cut4,
                              ["sd15_unet"] + cut4),
        "style": [(1, "vision_1"), (1, "style_adapter"),
                  (STEPS, "sd15_style_unet"), (1, "sd15_decode")],
        "safety_check": [(1, "vision_safety")],
    }


def _clip_shapes():
    """(K1 rows, K2a + K2b rows) of the clip phase that phase 3's other
    rows lack: the vision tower's attention on 1, 4 and 8 images, the
    style adapter's, the UNet's cross-attention against 85 tokens, the
    cutout decode's mid block (784 tokens of one 512 head) and its convs
    at 28² to 224²."""
    cn_attn, cn_conv = _controlnet_shapes()
    c5_attn, c5_conv = _c5_shapes()
    adj_attn, adj_conv = _adjust_shapes()
    up_attn, up_conv = _upscaler_shapes()
    seen_attn = {r[1:6] for r in ATTN_SHAPES + MODE_ATTN_SHAPES + cn_attn +
                 c5_attn + adj_attn + _hinter_shapes() + up_attn}
    seen_conv = {r[1:6] for r in CONV_SHAPES + MODE_CONV_SHAPES + cn_conv +
                 c5_conv + adj_conv + up_conv}
    attns, convs = [], []
    for call, (a, c) in _clip_calls().items():
        for dims in a:
            if dims not in seen_attn:
                seen_attn.add(dims)
                attns.append((f"{call}_{dims[0]}_{dims[2]}_{dims[3]}_"
                              f"d{dims[4]}", *dims))
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

# the pool phase, uint8 levels. A two-replica pool against one replica on
# each group's rows (the split, the threads, the gather: 0 measured), within
# POOL_LEVELS; against one replica's whole batch within BATCH_LEVELS (max)
# and BATCH_MEAN_LEVELS (mean): in bf16 one replica's images of 4 rows
# already differ from its images of 8 rows by 5 / 0.49 levels (its GEMMs
# and split-K convs take other tilings at other M). tp = 2 against tp = 1
# within TP_LEVELS / TP_MEAN_LEVELS: each shard's bf16 partial
# out-projection is rounded before the f32 sum, where one GEMM rounds once
# (4-5 / 0.52 measured). An index, split or head fault moves the mean by
# tens of levels.
POOL_LEVELS = 2
BATCH_LEVELS = 12
BATCH_MEAN_LEVELS = 1.0
TP_LEVELS = 12
TP_MEAN_LEVELS = 1.0
POOL_BATCH = 8
DRAW_SHAPE = (8, 128, 128, 4)      # SDXL's latents at batch 8


def _pool_shapes(tp: int = 2):
    """K1 at the tp = 2 split's shapes: the SD1.5 UNet's attentions at
    H / tp heads, at batch 1 and batch 8 (2 and 16 CFG rows)."""
    return [(f"tp{tp}_b{b}_{name}", 2 * b, h // tp, tq, tk, d)
            for b in (1, POOL_BATCH)
            for name, _b, h, tq, tk, d, _n in ATTN_SHAPES
            if name.startswith("unet_")]


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
         bound, plain_reps: int = 10):
    """One phase-3 row: the kernel's (max abs, relative) errors against its
    plain version, checked against ``bound_rel``; median times of kernel,
    plain version (``plain_reps`` calls a replay) and library call; the
    bound; launches per batch-1 call."""
    abs_err, err = errors
    row = {"shape": name, "dims": shape, "launches_per_call": launches,
           "max_abs_err": abs_err, "max_abs_err_rel": err,
           "bound": bound_rel, "ms": _timed(fn),
           "plain_ms": _timed(plain, reps=plain_reps),
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
            attn_bound(b, h, tq, tk, d),
            # past 4 GiB of f32 logits (the x4's 16384 tokens at 8 heads
            # and 2 rows: 17 GB), one plain call a replay
            plain_reps=1 if b * h * tq * tk * 4 > 1 << 32 else 10), **extra)
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
    # the adjust phase's shapes (the DPT's attention, SD1.5 at one row),
    # tagged apart
    adj_attn, adj_conv = _adjust_shapes()
    for shape in adj_attn:
        attn_row(*shape, 0, adjust=True)
    for shape in adj_conv:
        conv_row(*shape, 0, adjust=True)
    # the hinters phase's (UniFormer's attention), tagged apart
    for shape in _hinter_shapes():
        attn_row(*shape, 0, hinter=True)
    # the diffusion upscalers phase's (the x4 UNet and VAE, the k-UNet,
    # ToMe's merged attention), tagged apart
    up_attn, up_conv = _upscaler_shapes()
    for shape in up_attn:
        attn_row(*shape, 0, upscaler=True)
    for shape in up_conv:
        conv_row(*shape, 0, upscaler=True)
    # the clip phase's (the vision tower, the style adapter, the cross-
    # attention against 85 tokens, the cutout decode), tagged apart
    clip_attn, clip_conv = _clip_shapes()
    for shape in clip_attn:
        attn_row(*shape, 0, clip=True)
    for shape in clip_conv:
        conv_row(*shape, 0, clip=True)
    # the pool phase's tp = 2 shards (H/2 heads), tagged apart
    for shape in _pool_shapes():
        attn_row(*shape, 0, pool=True)
    for name, b, hw, c, eps, launches in GN_BATCH8_SHAPES:
        # not in a batch-1 call: no launches of its per-call sums
        record_stats(name, b, hw, c, eps, 0,
                     launches_per_batch8_call=launches)
    failed.extend(_grad_rows(rand))
    torch.cuda.synchronize()
    if failed:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(failed))
    return results


# a gradient through the kernels (their recompute Functions) against the
# plain twins' autograd on the same bf16 inputs, as max abs error over max
# |plain| of each gradient: the backward is the plain recompute itself, so
# only the forward's bf16 rounding (BF16_BOUND) reaches the gradients
GRAD_ROW_BOUND = BF16_BOUND


def _event_ms(fn, n: int = 5) -> float:
    """Milliseconds of one fn() on the card by CUDA events around n calls
    after 2 warm-ups (no graph capture: fn runs autograd's backward, whose
    host time is small beside its milliseconds of device work)."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _grad_rows(rand):
    """One row each for K1 and K2: one forward + backward through the
    Functions (ops/attention.py's FlashGrad, ops/fused_norm_conv.py's
    GnSiluConvGrad) against the plain twins' autograd, at the cond stem's
    UNet shapes (1 row, 64² latents), timed; the gradients held to the
    twins'. Returns the failures."""
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.ops import attention as A
    from gyre_tpu_torch.ops import fused_norm_conv as FC

    failed = []

    def row(kernel, dims, ins, fn, plain, flops):
        g = rand(*fn(*ins).shape)

        def grads(f):
            xs = [t.detach().requires_grad_() for t in ins]
            out = f(*xs)
            return [out] + list(torch.autograd.grad(out, xs, g))

        _build.reset_launches()
        got = grads(fn)
        launched = {k: v for k, v in _build.launches.items() if v}
        ref = grads(plain)
        errs = [_errors(a, b)[1] for a, b in zip(got, ref)]
        line = {"phase": "kernels", "grad": kernel, "dims": dims,
                "launches_fwd_bwd": launched, "max_abs_err_rel": errs,
                "bound": GRAD_ROW_BOUND,
                "ms": _event_ms(lambda: grads(fn)),
                "plain_ms": _event_ms(lambda: grads(plain)),
                "bound_ms": _bound(flops, PEAK_BF16_TC, 0)[0]}
        emit(line)
        if max(errs) > GRAD_ROW_BOUND:
            failed.append(f"{kernel} gradient: errors {errs}")
        return line

    # K1: self-attention at 64² latents, 8 heads of 40 (the forward and
    # the recompute's 4 products, 2 FLOP a multiply-add)
    b, h, t, d = 1, 8, 4096, 40
    q, k, v = (rand(b, t, h * d).view(b, t, h, d) for _ in range(3))
    row("flash_attention", [b, h, t, t, d], (q, k, v),
        lambda *x: A.attention(*x, scale=d ** -0.5),
        lambda *x: A._plain_bthd(*x, d ** -0.5), 6 * 4 * b * h * t * t * d)
    # K2a + K2b: a 64² resnet conv of 320 channels
    b, hw, c, co = 1, 64, 320, 320
    x = (torch.randn((b, hw, hw, c), device="cuda") * 2 + 0.5).to(
        torch.bfloat16)
    gs = rand(c, dtype=torch.float32, scale=0.1, shift=1.0)
    gb = rand(c, dtype=torch.float32, scale=0.1)
    w = rand(3, 3, c, co, scale=(9 * c) ** -0.5)
    cb = rand(co, dtype=torch.float32, scale=0.1)
    row("gn_silu_conv3x3", [b, hw, hw, c, co], (x, gs, gb, w, cb),
        lambda *a: FC.gn_silu_conv3x3(*a, groups=32, eps=1e-5),
        lambda *a: FC.gn_silu_conv3x3_plain(*a, groups=32, eps=1e-5),
        3 * 2 * b * hw * hw * co * 9 * c)
    return failed


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


def _generator_draw(keys, path, shape, device, dist="normal"):
    """The draw the port made before its threefry (per-seed CPU
    torch.Generators into pinned memory, copied without blocking), kept
    here only to time against utils/rng.py's ``draw``."""
    import zlib

    import torch

    seeds = []
    for key in keys:
        seed, *subs = key if isinstance(key, tuple) else (int(key),)
        name = ":".join(str(p) for p in (*subs, *path))
        name = f"uniform/{name}" if dist == "uniform" else name
        seeds.append((int(seed) ^ zlib.crc32(name.encode())) & 0xFFFFFFFF)
    device = torch.device(device)
    out = torch.empty((len(seeds), *shape), dtype=torch.float32,
                      pin_memory=device.type == "cuda")
    fill = torch.rand if dist == "uniform" else torch.randn
    for row, seed in zip(out, seeds):
        fill(tuple(shape), generator=torch.Generator().manual_seed(seed),
             out=row)
    return out.to(device, non_blocking=True)


def _levels(a, b) -> tuple[int, float]:
    """(max, mean) |a - b| of two uint8 image batches, in levels."""
    d = (a.int() - b.int()).abs()
    return int(d.max()), float(d.float().mean())


def phase_pool():
    """The device mesh on the card: a pool of two replicas and a tp = 2
    split on cuda:0 (and a pool over every visible GPU) against one
    replica, with exact launches; then threefry's host cost."""
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.models.modelset import random_preset
    from gyre_tpu_torch.parallel import mesh as pmesh
    from gyre_tpu_torch.parallel.pool import PooledPipeline
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline
    from gyre_tpu_torch.utils import rng

    bf = torch.bfloat16
    ms = random_preset("sd15", seed=0, dtype=bf, device="cuda")
    kw = dict(REQUEST, output_dtype="uint8", chunk_steps=10,
              stop_event=threading.Event())

    def pooled(devices, tp=1):
        mesh = pmesh.make_mesh(devices, tp=tp)
        return PooledPipeline([UnifiedPipeline(m, compute_dtype=bf)
                               for m in pmesh.shard_modelset(ms, mesh)])

    pipes = {"one": UnifiedPipeline(ms, compute_dtype=bf),
             "dp2": pooled(["cuda:0", "cuda:0"]),
             "tp2": pooled(["cuda:0", "cuda:0"], tp=2)}
    n_gpu = torch.cuda.device_count()
    if n_gpu > 1:
        pipes[f"dp{n_gpu}_gpus"] = pooled(None)
    # one call's launches: K1 32 a UNet call (twice under tp = 2: each
    # shard launches; the VAE's one head is not split) + 1 a decode, K2a
    # and K2b 44 a UNet call + 28, once a dp group
    k1 = {"one": 32, "dp2": 32, "tp2": 64, f"dp{n_gpu}_gpus": 32}
    groups = {"one": 1, "dp2": 2, "tp2": 1, f"dp{n_gpu}_gpus": n_gpu}
    failed = []
    seeds8 = list(range(300, 300 + POOL_BATCH))

    def counted(name, seeds):
        _build.reset_launches()
        out, host = _call(pipes[name], seeds, kw)
        got = dict(_build.launches)
        g = min(groups[name], len(seeds))
        want = {"flash_attention": g * (k1[name] * STEPS + 1),
                "gn_stats": g * (44 * STEPS + 28),
                "gn_silu_conv3x3": g * (44 * STEPS + 28)}
        if got != want:
            failed.append(f"{name} at {len(seeds)}: launches {got} != {want}")
        if tuple(out.shape) != (len(seeds), 512, 512, 3) or \
                out.dtype != torch.uint8:
            failed.append(f"{name}: image {tuple(out.shape)} {out.dtype}")
        return out, host["wall_s"], got

    for name, pipe in pipes.items():                     # warm-up
        pipe(seeds=seeds8, **kw)
    out = {}
    for b, seeds in ((POOL_BATCH, seeds8), (1, [7])):
        ref, walls = None, {}
        for name in pipes:
            if b == 1 and name not in ("one", "tp2"):
                continue
            img, wall, launches = counted(name, seeds)
            walls[name] = [wall, counted(name, seeds)[1]]
            out[f"launches_b{b}_{name}"] = launches
            if ref is None:
                ref = img
                continue
            if name.startswith("dp"):
                # each group's rows against one replica on the same rows:
                # the split, the threads and the gather alone
                per = torch.cat([_call(pipes["one"], seeds[a:z], kw)[0]
                                 for a, z in pmesh.row_groups(
                                     len(seeds), groups[name])])
                out[f"levels_b{b}_{name}_vs_groups"] = list(
                    _levels(img, per))
                out[f"levels_b{b}_one_by_groups_vs_one"] = list(
                    _levels(per, ref))
                if _levels(img, per)[0] > POOL_LEVELS:
                    failed.append(f"{name} at {b}: groups")
            mx, mean = _levels(img, ref)
            out[f"levels_b{b}_{name}"] = [mx, mean]
            lim = (TP_LEVELS, TP_MEAN_LEVELS) if name.startswith("tp") \
                else (BATCH_LEVELS, BATCH_MEAN_LEVELS)
            if mx > lim[0] or mean > lim[1]:
                failed.append(f"{name} at {b}: {mx} / {mean:.3f} levels")
        out[f"walls_b{b}_s"] = walls
    emit({"phase": "pool", "mesh": {k: v for k, v in groups.items()
                                    if k in pipes},
          "pool_levels": POOL_LEVELS, "batch_levels": BATCH_LEVELS,
          "batch_mean_levels": BATCH_MEAN_LEVELS, "tp_levels": TP_LEVELS,
          "tp_mean_levels": TP_MEAN_LEVELS,
          "k1_per_unet_call": {k: v for k, v in k1.items() if k in pipes},
          **out})

    # A2: a draw of SDXL's batch-8 latents, host time until it returns
    # (its work queued) and until the card has it, threefry against the
    # generators it replaced; then the batch-1 p50 with each, alternating
    def draw_cost(fn):
        host, ready = [], []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = fn(list(range(8 * i, 8 * i + 8)), ("init", 0),
                   DRAW_SHAPE[1:], "cuda")
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            ready.append(time.perf_counter() - t0)
        if tuple(x.shape) != DRAW_SHAPE or not bool(x.isfinite().all()):
            failed.append(f"draw {tuple(x.shape)}")
        return sorted(host)[2] * 1e3, sorted(ready)[2] * 1e3, \
            float(x.std())

    threefry_draw = rng.draw
    costs = {"threefry": draw_cost(threefry_draw),
             "generator": draw_cost(_generator_draw)}
    p50 = {"threefry": [], "generator": []}
    try:
        for i in range(10):
            which = ("threefry", "generator")[i % 2]
            rng.draw = threefry_draw if which == "threefry" else \
                _generator_draw
            p50[which].append(_call(pipes["one"], [20 + i], kw)[1]["wall_s"])
    finally:
        rng.draw = threefry_draw
    emit({"phase": "pool", "check": "threefry",
          "draw_shape": list(DRAW_SHAPE),
          **{f"draw_{k}_host_ms": v[0] for k, v in costs.items()},
          **{f"draw_{k}_ready_ms": v[1] for k, v in costs.items()},
          **{f"draw_{k}_std": v[2] for k, v in costs.items()},
          "batch1_walls_s": p50,
          **{f"batch1_p50_{k}_s": sorted(v)[len(v) // 2]
             for k, v in p50.items()}})
    del pipes, ms
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("pool: " + "; ".join(failed))


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


# ------------------------------------------ adjustments, depth engines


def _client_builders():
    """client.py's own request builders (build_request and its helpers),
    read from the repo's client.py with the port's protocol stubs in place
    of the JAX package's, which client.py imports (and this script may
    not): its top-level imports of the JAX package are dropped from the
    parsed source, and ``pb`` and ``PROTO_SAMPLERS`` given instead."""
    import ast
    import os

    from gyre_tpu_torch.pipeline.samplers import PROTO_SAMPLERS
    from gyre_tpu_torch.services.generate import pb

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "client.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.ImportFrom) and (n.module or "").split(".")[0] in
        ("gyre_tpu", "__future__"))]
    ns = {"__name__": "smoke_client", "pb": pb,
          "PROTO_SAMPLERS": PROTO_SAMPLERS}
    exec(compile(tree, path, "exec"), ns)
    return ns


def _client_request(ns, argv):
    """The Request client.py's main builds for ``argv`` (its
    build_request, captured before anything is sent)."""
    class Built(Exception):
        pass

    build = ns["build_request"]

    def capture(args):
        raise Built(build(args))

    ns["build_request"] = capture
    try:
        ns["main"](argv)
    except Built as b:
        return b.args[0]
    finally:
        ns["build_request"] = build
    raise AssertionError("client.py built no request")


ADJUST_SEQ_ROUNDS = 3


def _device_profile(fn, top: int = 8):
    """One traced fn(): its wall, the card's busy time (the sum of its
    device operations), their count and the ``top`` operations by device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            slot = by_name.setdefault(e.name[:60], [0.0, 0])
            slot[0] += e.time_range.elapsed_us() / 1e3
            slot[1] += 1
    return {"traced_wall_s": wall,
            "device_busy_s": sum(v[0] for v in by_name.values()) / 1e3,
            "device_ops": sum(v[1] for v in by_name.values()),
            "top_device_ms": [(n, round(v[0], 3), v[1]) for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:top]]}


def phase_adjust():
    """Adjustment chains, the DPT-Large and ZoeDepth engines and
    cfg_sequential on full-width SD1.5 (module docstring, 5g)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.models import configs, dpt, load, zoedepth
    from gyre_tpu_torch.models.modelset import random_preset
    from gyre_tpu_torch.ops import images as I
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline
    from gyre_tpu_torch.services import adjustments
    from gyre_tpu_torch.services.generate import pb

    failed = []
    ucfg = configs.SD15.unet
    k1_dpt = dpt.DPT_LARGE.layers           # one K1 launch a block
    size = REQUEST["height"]
    img_np = _mode_inputs(size)[0]                       # [1,H,W,3]
    yy, xx = np.mgrid[0:size, 0:size]
    alpha = np.ones((size, size, 1), np.float32)
    alpha[96:288, 160:352] = 0.0                         # the hole
    rgba = np.concatenate([img_np[0], alpha], -1)

    # --- cfg_sequential against parallel, one pipeline, batch 1
    pipe = UnifiedPipeline(random_preset("sd15", seed=0, device="cuda"),
                           compute_dtype=torch.bfloat16)
    kw = dict(REQUEST, seeds=[41])
    with _Counted() as counted:
        par = pipe(**kw)                                      # warm-up
        seq = counted.run("adjust", "cfg_sequential",
                          lambda: pipe(**kw, cfg_sequential=True), {
                              "flash_attention": 32 * 2 * STEPS + 1,
                              "gn_stats": 44 * 2 * STEPS + 28,
                              "gn_silu_conv3x3": 44 * 2 * STEPS + 28},
                          (2 * STEPS, 0, 1), size, failed)
    par = pipe(**kw)
    walls = {"parallel": [], "sequential": []}
    for r in range(ADJUST_SEQ_ROUNDS):
        order = ("parallel", "sequential") if r % 2 == 0 else \
            ("sequential", "parallel")
        for name in order:
            walls[name].append(_median_wall(lambda: pipe(
                **kw, cfg_sequential=name == "sequential"), 1)[0])
    abs_err, rel = _errors(seq, par)
    emit({"phase": "adjust", "check": "cfg_sequential",
          "max_abs_diff": abs_err, "mean_abs_diff": float(
              (seq.float() - par.float()).abs().mean()),
          "bound": BF16_BOUND, "walls_s": walls,
          "wall_s": {k: sorted(v)[len(v) // 2] for k, v in walls.items()}})
    if abs_err > BF16_BOUND:
        failed.append(f"cfg_sequential: {abs_err} off the parallel image")
    del pipe, par, seq
    torch.cuda.empty_cache()

    # --- a chain of every pure adjustment at 512², card against CPU
    def chain(spec):
        req = pb.Request()
        adj = req.prompt.add().artifact.adjustments
        for field, attrs in spec:
            a = adj.add()
            getattr(a, field).SetInParent()
            for k, v in attrs.items():
                if isinstance(v, list):
                    getattr(getattr(a, field), k).extend(v)
                else:
                    setattr(getattr(a, field), k, v)
        return adj

    smooth = chain([
        ("levels", {"input_low": 0.05, "input_high": 0.9}),
        ("blur", {"sigma": 2.0}),
        ("blur", {"sigma": 8.0, "direction": pb.DIRECTION_UP}),
        ("invert", {}),
        ("channels", {"r": pb.CHANNEL_B, "g": pb.CHANNEL_R,
                      "b": pb.CHANNEL_G, "a": pb.CHANNEL_ONE}),
        ("rescale", {"height": 384, "width": 640,
                     "mode": pb.RESCALE_CONTAIN_REPLICATE}),
        ("autoscale", {"height": size, "width": size}),
        ("crop", {"top": 32, "left": 16, "height": 448, "width": 480})])
    thresholded = {
        "canny_edge": chain([("canny_edge", {"low_threshold": 0.05,
                                             "high_threshold": 0.2})]),
        "palletize": chain([("palletize", {"colours": 8})]),
        "quantize": chain([("quantize", {"threshold": [0.45]})])}
    x_cpu = torch.from_numpy(img_np)
    ref = adjustments.apply_image_adjustment(x_cpu, smooth)
    got = adjustments.apply_image_adjustment(x_cpu.cuda(), smooth)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        adjustments.apply_image_adjustment(x_cpu.cuda(), smooth)
    torch.cuda.synchronize()
    chain_ms = (time.perf_counter() - t0) / 5 * 1e3
    err = float((got.cpu() - ref).abs().max())
    line = {"phase": "adjust", "check": "pure_chain_card_vs_cpu",
            "shape": list(got.shape), "max_abs_diff": err, "bound": 1e-4,
            "wall_ms": chain_ms, "flipped": {}}
    if err > 1e-4 or list(got.shape) != [1, 448, 480, 4]:
        failed.append(f"pure chain: {err} off the CPU's")
    # a threshold flips only where its input lies within rounding of it:
    # the share of values a level apart (more than 1e-5: a division by a
    # scalar rounds differently on the card), on the CPU chain's output
    for name, adj in thresholded.items():
        a = adjustments.apply_image_adjustment(ref, adj)
        b = adjustments.apply_image_adjustment(ref.cuda(), adj).cpu()
        share = float(((a - b).abs() > 1e-5).float().mean())
        line["flipped"][name] = share
        if share > 1e-3:
            failed.append(f"{name}: {share} of the values flipped")
    flow = I.shuffle_flow(ref.shape, 7)
    same = bool(torch.equal(I.shuffle(ref, flow),
                            I.shuffle(ref.cuda(), flow).cpu()))
    line["shuffle_equal"] = same
    if not same:
        failed.append("shuffle: card and CPU move pixels apart")
    emit(line)

    # --- checkpoints: DPT-Large (Intel/dpt-large layout) and ZoeD_N over
    # it (the trunk under core.core.), random from seed 0, bf16 on disk
    tmp = tempfile.mkdtemp(prefix="gyre-smoke-depth-")
    manager = serving = channel = None
    try:
        t0 = time.perf_counter()
        model = dpt.random_dpt(dpt.DPT_LARGE, seed=0, dtype=torch.bfloat16,
                               device="cpu")
        state = {k: v.to(torch.bfloat16)
                 for k, v in dpt.state_dict_hf(model).items()}
        n_params = sum(v.numel() for v in state.values())
        del model
        dpt_path = os.path.join(tmp, "dpt-large.safetensors")
        load.write_safetensors(dpt_path, state)
        zstate = {f"core.core.{k}": v for k, v in state.items()}
        zstate.update(zoedepth.state_dict_published(zoedepth.random_head(
            zoedepth.ZOE_N, seed=0, device="cpu")))
        zoe_path = os.path.join(tmp, "zoe.safetensors")
        load.write_safetensors(zoe_path, zstate)
        del state, zstate
        cn_path = os.path.join(tmp, "cn.safetensors")
        load.write_safetensors(cn_path, load.export_controlnet_state(
            _live_controlnet(ucfg, 1), ucfg))
        emit({"phase": "adjust", "checkpoints_s": time.perf_counter() - t0,
              "dpt_params": n_params,
              "dpt_bytes": os.path.getsize(dpt_path),
              "zoe_bytes": os.path.getsize(zoe_path)})
        if not 340e6 < n_params < 346e6:
            failed.append(f"DPT-Large has {n_params} parameters")

        types = ("depth", "canny", "color", "shuffle")
        manager, serving, tmp2 = _serve_yaml(
            "- {id: sd15, default: true, hintset: hs, model: {preset: "
            "sd15, seed: 0}}\n"
            f"- {{id: midas-depth, task: depth, model: {dpt_path}}}\n"
            f"- {{id: zoe-depth, task: depth, kind: zoedepth, model: "
            f"{zoe_path}}}\n"
            f"- {{model_id: smoke-cn, model: {cn_path}}}\n"
            "- {hintset_id: hs, " + ", ".join(
                f"controlnet/{t}: {{aliases: [{t}], model: '@smoke-cn'}}"
                for t in types) + "}\n")
        shutil.rmtree(tmp2, ignore_errors=True)
        ready = {s["id"]: s["ready"] for s in manager.status()}
        t0 = time.perf_counter()
        runs = {eid: manager.task_pipeline("depth", eid)
                for eid in ("midas-depth", "zoe-depth")}
        load_s = time.perf_counter() - t0
        kinds = {s["id"]: s["weights"] for s in manager.status()}
        trunk = runs["midas-depth"].models[0]
        emit({"phase": "adjust", "ready": ready, "weights": kinds,
              "depth_load_s": load_s, "dpt_config": str(trunk.cfg),
              "dpt_dtype": str(trunk.dtype), "size": runs["midas-depth"].size})
        if not (ready["midas-depth"] and ready["zoe-depth"]):
            failed.append(f"depth engines not ready: {ready}")
        if kinds["midas-depth"] != "real" or kinds["zoe-depth"] != "real":
            failed.append(f"depth weights {kinds}, expected real")
        if trunk.cfg != dpt.DPT_LARGE or \
                runs["zoe-depth"].models[1].cfg != zoedepth.ZOE_N:
            failed.append("the depth engines are not DPT-Large / ZoeD_N")

        # the estimates, on the card: launches (24 K1 at [1, 577, 16, 64],
        # no K2), walls, the map; the DPT's against its f32 on the CPU
        x = torch.from_numpy(img_np).cuda()
        for eid, run in runs.items():
            run(x)                                       # warm-up
            _build.reset_launches()
            out = run(x)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.launches.items() if v}
            wall = _median_wall(lambda: run(x), 5)
            expect = {"flash_attention": k1_dpt}
            line = {"phase": "adjust", "estimate": eid, "wall_s": wall[0],
                    "launches": launches, "expected_launches": expect,
                    "shape": list(out.shape),
                    "finite": bool(out.isfinite().all()),
                    "min": float(out.min()), "max": float(out.max()),
                    "std": float(out.float().std()),
                    **_device_profile(lambda: run(x))}
            if eid == "midas-depth":
                cpu, _ = dpt.load_dpt(dpt.state_dict_hf(trunk),
                                      dtype=torch.float32, device="cpu")
                with torch.inference_mode():
                    f32 = dpt.estimate_depth(cpu, torch.from_numpy(img_np),
                                             run.size)
                line["max_abs_diff_to_f32_cpu"] = float(
                    (out[..., :1].cpu() - f32).abs().max())
                line["mean_abs_diff_to_f32_cpu"] = float(
                    (out[..., :1].cpu() - f32).abs().mean())
                del cpu
                if line["max_abs_diff_to_f32_cpu"] > 0.1:
                    failed.append(f"DPT bf16 on the card "
                                  f"{line['max_abs_diff_to_f32_cpu']} off "
                                  "its f32 on the CPU")
            emit(line)
            failed.extend(f"estimate {eid}: {what}" for what, bad in (
                (f"launches {launches} != {expect}", launches != expect),
                ("shape", line["shape"] != [1, size, size, 3]),
                ("not finite", not line["finite"]),
                ("out of [0, 1]", line["min"] < 0 or line["max"] > 1 + 1e-6),
                ("flat map", line["std"] < 0.01)) if bad)

        # --- client.py's requests over gRPC
        ns = _client_builders()
        channel, generate = _grpc_generate(serving.grpc_port)
        init_path = os.path.join(tmp, "init.png")
        with open(init_path, "wb") as fh:
            fh.write(I.encode_png(rgba))
        hint_path = os.path.join(tmp, "hint.png")
        with open(hint_path, "wb") as fh:
            fh.write(I.encode_png(img_np[0]))
        base = [REQUEST["prompt"], "-n", REQUEST["negative_prompt"],
                "--host", "localhost:1", "-W", str(size), "-H", str(size),
                "--steps", str(STEPS), "-s", "k_dpmpp_2m", "-S", "51"]
        cases = {
            "mask_from_image_alpha": ["-e", "sd15", "-i", init_path,
                                      "--mask_from_image_alpha"],
            "plain_hint": ["-e", "sd15", "--hint", f"canny:{hint_path}"],
            **{f"hint_from_image_{t}": ["-e", "sd15", "--hint_from_image",
                                        f"{t}:{hint_path}"] for t in types},
            "midas_engine": ["-e", "midas-depth", "-i", hint_path],
            "zoe_engine": ["-e", "zoe-depth", "-i", hint_path]}
        hinted = {"flash_attention": 921, "gn_stats": 1308,
                  "gn_silu_conv3x3": 1308}
        expect = {name: hinted for name in cases}
        expect["mask_from_image_alpha"] = {
            "flash_attention": 32 * STEPS + 2, "gn_stats": 44 * STEPS + 48,
            "gn_silu_conv3x3": 44 * STEPS + 48}        # + a VAE encode
        expect["hint_from_image_depth"] = dict(
            hinted, flash_attention=921 + k1_dpt)
        expect["midas_engine"] = expect["zoe_engine"] = {
            "flash_attention": k1_dpt}
        images = {}
        for name, argv in cases.items():
            req = _client_request(ns, base + argv)
            generate(req)                                # warm-up
            _build.reset_launches()
            t0 = time.perf_counter()
            images[name] = got = generate(req)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _build.launches.items() if v}
            emit({"phase": "adjust", "grpc": name, "wall_s": wall,
                  "launches": launches, "expected_launches": expect[name],
                  "shape": list(got.shape),
                  "adjustments": [len(p.artifact.adjustments)
                                  for p in req.prompt
                                  if p.WhichOneof("prompt") == "artifact"]})
            failed.extend(f"gRPC {name}: {what}" for what, bad in (
                (f"launches {launches} != {expect[name]}",
                 launches != expect[name]),
                (f"shape {got.shape}", got.shape != (size, size, 3)),
                ("constant image", got.min() == got.max())) if bad)
        # the hinted requests' walls, paired (the plain ControlNet request
        # of the hints phase, then the depth-hinted one), median of 3
        hint_walls = {"plain_hint": [], "hint_from_image_depth": []}
        for r in range(3):
            for name in (list(hint_walls) if r % 2 == 0 else
                         list(hint_walls)[::-1]):
                req = _client_request(ns, base + cases[name])
                t0 = time.perf_counter()
                generate(req)
                hint_walls[name].append(time.perf_counter() - t0)
        emit({"phase": "adjust", "check": "hinted_walls",
              "walls_s": hint_walls,
              "wall_s": {k: sorted(v)[1] for k, v in hint_walls.items()}})
        # the kept pixels of the alpha-masked request are the init image's
        mask = adjustments.apply_image_adjustment(
            torch.from_numpy(rgba[None]), _client_request(
                ns, base + cases["mask_from_image_alpha"]).prompt[-1]
            .artifact.adjustments).numpy()[..., :1]
        keep = _kept_pixels(mask)
        init_u8 = np.round(img_np[0] * 255).astype(np.uint8)
        kept_equal = bool((images["mask_from_image_alpha"][keep] ==
                           init_u8[keep]).all())
        emit({"phase": "adjust", "check": "alpha_mask_kept_pixels",
              "kept": int(keep.sum()), "equal_to_init": kept_equal,
              "regenerated_differs": bool((images["mask_from_image_alpha"][
                  ~keep] != init_u8[~keep]).any())})
        if not kept_equal or keep.all() or not keep.any():
            failed.append("alpha mask: the kept pixels are not the init's")
        # the depth-hinted image against the same request in-process, its
        # hint the DPT engine's map of the decoded upload
        hint = runs["midas-depth"](torch.from_numpy(
            I.decode_png(I.encode_png(img_np[0]))).cuda())
        want = manager.dispatch_view("sd15").pipe(**dict(
            REQUEST, seeds=[51], output_dtype="uint8", chunk_steps=10,
            stop_event=threading.Event(), hints=[{
                "params": manager.hint_model("depth", "sd15")["params"],
                "kind": "controlnet", "image": hint.cpu().numpy(),
                "scale": 1.0}]))[0].cpu().numpy()
        diff = int(np.abs(images["hint_from_image_depth"].astype(int) -
                          want.astype(int)).max())
        emit({"phase": "adjust", "check": "depth_hint_in_process",
              "max_diff": diff})
        if diff > 1:
            failed.append(f"depth hint: {diff} levels off in-process")
        if (images["hint_from_image_depth"] ==
                images["hint_from_image_canny"]).all():
            failed.append("depth and canny hints gave one image")
    finally:
        if channel is not None:
            channel.close()
        if serving is not None:
            serving.stop(0)
        if manager is not None:
            manager.dispatcher.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("adjust: " + "; ".join(failed))



# ------------------------------------------------------------ hinters

# the hinter engines of config/engines/utility.yaml: (id, task, kind, the
# published-layout exporter and loader of its model)
def _hinter_table():
    from gyre_tpu_torch.models import baenormal, hinters, mlsd, pose
    from gyre_tpu_torch.models import uniformer as uni

    def first(load):            # loaders that return (model, config)
        return lambda state, **kw: load(state, **kw)[0]

    return [
        ("hed-edge", "edge", None, hinters.state_dict_hed,
         hinters.load_hed, lambda: hinters.random_hed(0, device="cuda")),
        ("lineart", "hinter", "lineart", hinters.state_dict_drawings,
         hinters.load_drawings,
         lambda: hinters.random_drawings(0, device="cuda")),
        ("dexined-edge", "hinter", "dexined", hinters.state_dict_dexined,
         hinters.load_dexined,
         lambda: hinters.random_dexined(0, device="cuda")),
        ("openpose", "pose", None, pose.state_dict_body, pose.load_body,
         lambda: pose.random_body(0, device="cuda")),
        ("segmentation", "segmentation", None, uni.state_dict_uniformer,
         first(uni.load_uniformer),
         lambda: uni.random_uniformer(uni.UNIFORMER_SMALL, 0,
                                      device="cuda")),
        ("bae-normal", "normal", "bae", baenormal.state_dict_baenormal,
         first(baenormal.load_baenormal),
         lambda: baenormal.random_baenormal(baenormal.EFFNET_B5, 0,
                                            device="cuda")),
        ("mlsd-lines", "hinter", "mlsd", mlsd.state_dict_mlsd,
         mlsd.load_mlsd, lambda: mlsd.random_mlsd(0, device="cuda")),
    ]


def _hinter_vs_cpu(eid, model, load, export, x_np, failed):
    """The card's bf16 maps of ``model`` against the same weights in f32 on
    the CPU (loaded from its export): one line, the bound's failures
    appended to ``failed``."""
    import torch

    from gyre_tpu_torch.models import mlsd, pose

    cpu = load(export(model), dtype=torch.float32, device="cpu")
    x_cpu = torch.from_numpy(x_np)
    x_gpu = x_cpu.cuda()
    line = {"phase": "hinters", "bf16_vs_f32_cpu": eid,
            "size": HINTER_CPU_SIZE}

    def rel(a, b):
        a, b = a.float().cpu(), b.float()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)

    with torch.inference_mode():
        if eid == "segmentation":
            card = model.logits(x_gpu).argmax(-1).cpu()
            ref = cpu.logits(x_cpu).argmax(-1)
            share = float((card == ref).float().mean())
            line.update(same_class_share=share, bound=HINTER_CLASS_SHARE,
                        classes=int(ref.unique().numel()))
            if share < HINTER_CLASS_SHARE:
                failed.append(f"{eid}: {share} of pixels keep their class")
        elif eid == "openpose":
            maps_c = model(x_gpu)
            maps = cpu(x_cpu)
            errs = [rel(a, b) for a, b in zip(maps_c, maps)]
            # the decoders on the CPU's maps, card against CPU: as they
            # are, and each map scaled to a peak of 1 (random weights' maps
            # stay far under the published thresholds, 0.1 and 0.05)
            heat, pafs = maps
            equal, limbs = True, 0
            size = x_np.shape[1:3]
            for h, p in ((heat, pafs), (
                    heat / heat.amax(dim=(1, 2), keepdim=True),
                    pafs / pafs.abs().amax(dim=(1, 2), keepdim=True))):
                for style in ("openpose", "keypose"):
                    a = pose.render_multi(h, p, *size, True, style=style)
                    b = pose.render_multi(h.cuda(), p.cuda(), *size, True,
                                          style=style)
                    equal &= bool(torch.equal(a, b.cpu()))
                xy, conf = pose.top_peaks(h, apply_sigmoid=False)
                limbs = int(pose.match_limbs(xy[0], conf[0], p[0], 0.1)[2]
                            .sum())
            line.update(max_abs_diff_rel=errs, bound=HINTER_MAP_BOUND,
                        decode_equal=equal, scaled_limbs=limbs,
                        heat_max=float(heat.max()))
            if max(errs) > HINTER_MAP_BOUND:
                failed.append(f"{eid}: maps {errs} off the CPU's")
            if not equal:
                failed.append(f"{eid}: the card decodes the CPU's maps "
                              "apart")
        elif eid == "mlsd-lines":
            def tp_of(m, x):
                y = mlsd.resize(x.float(), (mlsd.INPUT_SIZE,) * 2,
                                "bilinear") * 2.0 - 1.0
                return m.tp_map(torch.cat([y, torch.ones_like(y[..., :1])],
                                          -1))

            tp_c, tp = tp_of(model, x_gpu), tp_of(cpu, x_cpu)
            err = rel(tp_c, tp)
            # the decode of the CPU's heat (after the sigmoid, whose last
            # bit differs between devices) and displacements, card against
            # CPU: as they are, and with the displacements scaled to 8 px
            # at most (random weights' segments stay under the published
            # 0.1 px length)
            heat, disp = mlsd.nms_heat(tp[..., 7]), tp[..., 8:12]
            size = x_np.shape[1:3]
            equal, valid_n = True, []
            for d in (disp, disp * (8.0 / float(disp.abs().max()))):
                segs, valid, _ = mlsd.decode(heat, d)
                segs_c, valid_c, _ = mlsd.decode(heat.cuda(), d.cuda())
                ren = mlsd.render_segments(segs, valid, *size)
                ren_c = mlsd.render_segments(segs_c, valid_c, *size).cpu()
                equal &= bool(torch.equal(ren, ren_c) and
                              torch.equal(valid, valid_c.cpu()))
                valid_n.append(int(valid.sum()))
            line.update(max_abs_diff_rel=err, bound=HINTER_MAP_BOUND,
                        decode_equal=equal, valid_segments=valid_n)
            if err > HINTER_MAP_BOUND:
                failed.append(f"{eid}: map {err} off the CPU's")
            if not equal:
                failed.append(f"{eid}: the card decodes the CPU's map apart")
        else:
            err = rel(model(x_gpu), cpu(x_cpu))
            bound = HINTER_MAP_BOUNDS.get(eid, HINTER_MAP_BOUND)
            line.update(max_abs_diff_rel=err, bound=bound)
            if err > bound:
                failed.append(f"{eid}: map {err} off the CPU's")
    del cpu
    emit(line)


def phase_hinters():
    """The D3 hinter engines at full width from disk: load, an estimate
    each with its launches, memory and walls, the card's bf16 against the
    CPU's f32, client.py's hint conversions and requests to each engine
    over gRPC."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.models import configs, load, uniformer
    from gyre_tpu_torch.ops import images as I

    t_phase = time.perf_counter()
    failed = []
    ucfg = configs.SD15.unet
    size = HINTER_SIZE
    k1_uni = sum(uniformer.UNIFORMER_SMALL.layers[2:])   # one a SA block
    img_np = _mode_inputs(size)[0]
    table = _hinter_table()
    tmp = tempfile.mkdtemp(prefix="gyre-smoke-hinters-")
    manager = serving = channel = None
    try:
        # --- full-width random models (seed 0, drawn on the card) in their
        # published layouts, bf16 on disk
        paths, sizes = {}, {}
        t0 = time.perf_counter()
        for eid, _, _, export, _, make in table:
            model = make()
            state = {k: torch.from_numpy(v).to(torch.bfloat16)
                     for k, v in export(model).items()}
            paths[eid] = os.path.join(tmp, f"{eid}.safetensors")
            load.write_safetensors(paths[eid], state)
            sizes[eid] = (sum(p.numel() for p in model.parameters()),
                          os.path.getsize(paths[eid]))
            del model, state
        cn_path = os.path.join(tmp, "cn.safetensors")
        load.write_safetensors(cn_path, load.export_controlnet_state(
            _live_controlnet(ucfg, 1), ucfg))
        emit({"phase": "hinters", "checkpoints_s": time.perf_counter() - t0})
        types = ("hed", "sketch", "segmentation", "openpose", "keypose",
                 "normal")
        manager, serving, tmp2 = _serve_yaml(
            "- {id: sd15, default: true, hintset: hs, model: {preset: "
            "sd15, seed: 0}}\n" + "".join(
                f"- {{id: {eid}, task: {task}, "
                + (f"kind: {kind}, " if kind else "")
                + f"model: {paths[eid]}}}\n"
                for eid, task, kind, *_ in table)
            + f"- {{model_id: smoke-cn, model: {cn_path}}}\n"
            "- {hintset_id: hs, " + ", ".join(
                f"controlnet/{t}: {{aliases: [{t}], model: '@smoke-cn'}}"
                for t in types) + "}\n")
        shutil.rmtree(tmp2, ignore_errors=True)
        runs = {}
        for eid, task, *_ in table:
            t0 = time.perf_counter()
            runs[eid] = manager.task_pipeline(task, eid)
            torch.cuda.synchronize()
            model = runs[eid].models[0]
            emit({"phase": "hinters", "engine": eid,
                  "load_s": time.perf_counter() - t0,
                  "params": sizes[eid][0], "file_bytes": sizes[eid][1],
                  "model": type(model).__name__, "dtype": str(model.dtype)})
        status = {s["id"]: (s["ready"], s["weights"])
                  for s in manager.status()}
        emit({"phase": "hinters", "status": status})
        for eid, *_ in table:
            if status[eid] != (True, "real"):
                failed.append(f"{eid}: status {status[eid]}")

        # --- one estimate of the 512² image each: launches, peak memory,
        # the median wall of 3; a traced estimate of HED and UniFormer
        x = torch.from_numpy(img_np).cuda()
        for eid, *_ in table:
            run = runs[eid]
            run(x)                                        # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _build.reset_launches()
            out = run(x)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.launches.items() if v}
            expect = {"flash_attention": k1_uni} \
                if eid == "segmentation" else {}
            wall = _median_wall(lambda: run(x), 3)[0]
            line = {"phase": "hinters", "estimate": eid, "wall_s": wall,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "peak_over_weights_bytes":
                        torch.cuda.max_memory_allocated() - base,
                    "launches": launches, "expected_launches": expect,
                    "shape": list(out.shape),
                    "finite": bool(out.isfinite().all()),
                    "min": float(out.min()), "max": float(out.max()),
                    "std": float(out.float().std())}
            if eid in ("hed-edge", "segmentation"):
                prof = _device_profile(lambda: run(x))
                prof["busy_share"] = prof["device_busy_s"] / \
                    prof["traced_wall_s"]
                line.update(prof)
                slow = [n for n, *_ in prof["top_device_ms"]
                        if "fft" in n.lower() or "gemv" in n.lower()]
                if slow:
                    failed.append(f"{eid}: {slow} among the top device "
                                  "operations")
            emit(line)
            failed.extend(f"estimate {eid}: {what}" for what, bad in (
                (f"launches {launches} != {expect}", launches != expect),
                ("shape", line["shape"] != [1, size, size, 3]),
                ("not finite", not line["finite"]),
                ("out of [0, 1]", line["min"] < 0 or line["max"] > 1)) if bad)

        # --- the card's bf16 against the same weights in f32 on the CPU
        x_small = _mode_inputs(HINTER_CPU_SIZE)[0]
        for eid, _, _, export, load_fn, _ in table:
            _hinter_vs_cpu(eid, runs[eid].models[0], load_fn, export,
                           x_small, failed)

        # --- client.py's requests over gRPC
        ns = _client_builders()
        channel, generate = _grpc_generate(serving.grpc_port)
        hint_path = os.path.join(tmp, "hint.png")
        with open(hint_path, "wb") as fh:
            fh.write(I.encode_png(img_np[0]))
        argv = [REQUEST["prompt"], "-n", REQUEST["negative_prompt"],
                "--host", "localhost:1", "-W", str(size), "-H", str(size),
                "--steps", str(STEPS), "-s", "k_dpmpp_2m", "-S", "61"]
        cases = {"plain_hint": ["-e", "sd15", "--hint", f"hed:{hint_path}"],
                 **{f"hint_from_image_{t}": [
                     "-e", "sd15", "--hint_from_image", f"{t}:{hint_path}"]
                    for t in types},
                 **{f"engine_{eid}": ["-e", eid, "-i", hint_path]
                    for eid, *_ in table}}
        hinted = {"flash_attention": 921, "gn_stats": 1308,
                  "gn_silu_conv3x3": 1308}
        expect = {name: hinted for name in cases}
        expect["hint_from_image_segmentation"] = dict(
            hinted, flash_attention=921 + k1_uni)
        for eid, *_ in table:
            expect[f"engine_{eid}"] = {"flash_attention": k1_uni} \
                if eid == "segmentation" else {}
        reqs = {name: _client_request(ns, argv + a)
                for name, a in cases.items()}
        images, walls = {}, {name: [] for name in cases}
        for name, req in reqs.items():
            generate(req)                                # warm-up
        for r in range(2):              # timed in order, then reversed
            for name in (list(reqs) if r == 0 else list(reqs)[::-1]):
                _build.reset_launches()
                t0 = time.perf_counter()
                images[name] = got = generate(reqs[name])
                walls[name].append(time.perf_counter() - t0)
                if r:
                    continue
                launches = {k: v for k, v in _build.launches.items() if v}
                emit({"phase": "hinters", "grpc": name,
                      "launches": launches, "expected_launches":
                          expect[name], "shape": list(got.shape)})
                failed.extend(f"gRPC {name}: {what}" for what, bad in (
                    (f"launches {launches} != {expect[name]}",
                     launches != expect[name]),
                    (f"shape {got.shape}", got.shape != (size, size, 3)),
                    ("constant image", name.startswith("hint") and
                     got.min() == got.max())) if bad)
        emit({"phase": "hinters", "check": "grpc_walls", "walls_s": walls,
              "wall_s": {k: sum(v) / len(v) for k, v in walls.items()}})
        # each engine's answer against its in-process map of the decoded
        # upload, and the hed-hinted image against the same request
        # in-process (its hint the edge engine's map)
        upload = torch.from_numpy(I.decode_png(I.encode_png(img_np[0])))
        diffs = {}
        for eid, *_ in table:
            want = runs[eid](upload.cuda())[0].clamp(0, 1).cpu().numpy()
            diffs[eid] = float(np.abs(images[f"engine_{eid}"] / 255.0 -
                                      want).max())
        hint = runs["hed-edge"](upload.cuda())
        want = manager.dispatch_view("sd15").pipe(**dict(
            REQUEST, seeds=[61], output_dtype="uint8", chunk_steps=10,
            stop_event=threading.Event(), hints=[{
                "params": manager.hint_model("hed", "sd15")["params"],
                "kind": "controlnet", "image": hint.cpu().numpy(),
                "scale": 1.0}]))[0].cpu().numpy()
        diffs["hint_from_image_hed"] = int(np.abs(
            images["hint_from_image_hed"].astype(int) -
            want.astype(int)).max())
        emit({"phase": "hinters", "check": "grpc_equals_in_process",
              "max_diff": diffs})
        for name, d in diffs.items():
            if d > (1 if name.startswith("hint") else 1.0 / 255 + 1e-6):
                failed.append(f"{name}: {d} off the in-process image")
    finally:
        if channel is not None:
            channel.close()
        if serving is not None:
            serving.stop(0)
        if manager is not None:
            manager.dispatcher.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    emit({"phase": "hinters", "phase_s": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError("hinters: " + "; ".join(failed))


# ------------------------------------------------------------ upscalers

def _upscaler_table():
    """(engine id, task, kind, the published-layout exporter, the loader
    (model out), the full-width random model on the card) of the D3b/D4
    engines of config/engines/utility.yaml: RealESRGAN_x4plus, SwinIR-M x4
    classical (the shipped swinir-x4), HAT-M x4 and InSPyReNet-SwinB."""
    from gyre_tpu_torch.models import esrgan, hat, swinir
    from gyre_tpu_torch.models import inspyrenet as isp

    def first(load):
        return lambda state, **kw: load(state, **kw)[0]

    return [
        ("esrgan-x4", "upscaler", None, esrgan.state_dict_esrgan,
         esrgan.load_esrgan, lambda: esrgan.random_esrgan(23, 0)),
        ("swinir-x4", "upscaler", "swinir", swinir.state_dict_swinir,
         first(swinir.load_swinir),
         lambda: swinir.random_swinir(swinir.SWINIR_CLASSICAL, 0)),
        ("hat-x4", "upscaler", "hat", hat.state_dict_hat,
         first(hat.load_hat), lambda: hat.random_hat(hat.HAT_M, 0)),
        ("background-removal", "background_removal", None,
         isp.state_dict_inspyrenet, first(isp.load_inspyrenet),
         lambda: isp.random_inspyrenet(isp.SWIN_B, 64, 0)),
    ]


def _scene(h: int, w: int):
    """A [1,H,W,3] uint8-valued image of any shape: a bright subject (a
    disc and a bar over waves) on a darker gradient."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    bg = np.stack([0.2 + 0.3 * yy, 0.25 + 0.1 * np.sin(7 * xx),
                   0.3 * (1 - xx)], -1)
    disc = ((yy - 0.45) ** 2 + ((xx - 0.5) * w / h) ** 2 < 0.06)[..., None]
    bar = ((np.abs(yy - 0.75) < 0.06) & (np.abs(xx - 0.5) < 0.3))[..., None]
    fg = np.stack([0.9 - 0.3 * xx, 0.6 + 0.3 * np.sin(20 * yy * xx),
                   0.5 + 0.4 * yy], -1)
    img = np.where(disc | bar, fg, bg)
    return (np.round(np.clip(img, 0, 1) * 255) / 255)[None].astype(
        np.float32)


def _upscaler_vs_cpu(eid, model, load, export, failed):
    """The engine's model on the card (bf16 InSPyReNet and ESRGAN, f32
    SwinIR and HAT) against the same weights in f32 on the CPU, at
    UPSCALER_CPU_SIZES: one line."""
    import torch

    size = UPSCALER_CPU_SIZES[eid]
    cpu = load(export(model), dtype=torch.float32, device="cpu")
    x = torch.from_numpy(_scene(size, size))
    bound = UPSCALER_F32_BOUND if model.dtype == torch.float32 else \
        UPSCALER_BF16_BOUND
    with torch.inference_mode():
        if eid == "background-removal":     # the logits
            card = model(x.cuda(), return_logits=True).float().cpu()
            ref = cpu(x, return_logits=True)
        else:
            card = model(x.cuda()).float().cpu()
            ref = cpu(x)
    err = float((card - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-12)
    emit({"phase": "upscalers", "card_vs_cpu_f32": eid, "size": size,
          "card_dtype": str(model.dtype), "max_abs_diff_rel": err,
          "bound": bound, "cpu_max_abs": float(ref.abs().max()),
          "shape": list(card.shape)})
    if err > bound:
        failed.append(f"{eid}: {err} off the CPU's f32")
    del cpu


def _bg_engine_vs_cpu(path, failed):
    """The background-removal engine over ``path`` at BG_ENGINE_MAX_RES,
    the card's manager (bf16) against a CPU manager in f32 on one
    BG_ENGINE_SIZE image: the scaled, guided-filter geometry of
    manager._build_background_removal on both sides. One line."""
    import torch

    from gyre_tpu_torch.manager.manager import EngineManager

    h, w = BG_ENGINE_SIZE
    x = torch.from_numpy(_scene(h, w))
    spec = [{"id": "bg", "task": "background_removal", "model": path,
             "max_res": BG_ENGINE_MAX_RES}]
    outs = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        manager = EngineManager(spec, device=device, compute_dtype=dtype)
        try:
            run = manager.task_pipeline("background_removal", "bg")
            if run.size != BG_ENGINE_MAX_RES:
                failed.append(f"background removal at max_res "
                              f"{BG_ENGINE_MAX_RES}: ran at {run.size}")
            outs[device] = run(x.to(device)).float().cpu()
        finally:
            manager.dispatcher.stop()
    card, ref = outs["cuda"], outs["cpu"]
    diff = (card[..., 3] - ref[..., 3]).abs()
    guided = max(h, w) > BG_ENGINE_MAX_RES and \
        BG_ENGINE_MAX_RES / max(h, w) < 0.5
    emit({"phase": "upscalers", "card_vs_cpu_f32": "background-removal "
          "engine", "size": [h, w], "max_res": BG_ENGINE_MAX_RES,
          "guided_filter": guided, "alpha_max_abs_diff": float(diff.max()),
          "alpha_mean_abs_diff": float(diff.mean()),
          "bound": BG_ENGINE_ALPHA_BOUND,
          "cpu_alpha_mean": float(ref[..., 3].mean()),
          "cpu_alpha_std": float(ref[..., 3].std()),
          "shape": list(card.shape)})
    failed.extend(f"background removal engine vs CPU: {what}"
                  for what, bad in (
        ("not the guided-filter path", not guided),
        (f"shape {list(card.shape)}", list(card.shape) != [1, h, w, 4]),
        ("RGB changed", not torch.equal(card[..., :3], x)),
        ("a flat CPU alpha", float(ref[..., 3].std()) < 1e-3),
        (f"alpha {float(diff.max())} off the CPU's f32",
         not float(diff.max()) <= BG_ENGINE_ALPHA_BOUND)) if bad)


def phase_upscalers():
    """The D3b and D4 engines at published widths from disk (module
    docstring, 5i)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.models import configs, load
    from gyre_tpu_torch.ops import images as I
    from gyre_tpu_torch.services import adjustments

    t_phase = time.perf_counter()
    failed = []
    ucfg = configs.SD15.unet
    table = _upscaler_table()
    tmp = tempfile.mkdtemp(prefix="gyre-smoke-upscalers-")
    manager = serving = channel = None
    try:
        # --- full-width random models (seed 0, drawn on the card) in their
        # published layouts, bf16 on disk (index buffers as they are)
        paths, sizes = {}, {}
        t0 = time.perf_counter()
        for eid, _, _, export, _, make in table:
            model = make()
            state = {k: torch.from_numpy(np.asarray(v)) for k, v in
                     export(model).items()}
            state = {k: v.to(torch.bfloat16) if v.is_floating_point()
                     else v for k, v in state.items()}
            paths[eid] = os.path.join(tmp, f"{eid}.safetensors")
            load.write_safetensors(paths[eid], state)
            sizes[eid] = (sum(p.numel() for p in model.parameters()),
                          os.path.getsize(paths[eid]))
            del model, state
        cn_path = os.path.join(tmp, "cn.safetensors")
        load.write_safetensors(cn_path, load.export_controlnet_state(
            _live_controlnet(ucfg, 1), ucfg))
        emit({"phase": "upscalers",
              "checkpoints_s": time.perf_counter() - t0})
        manager, serving, tmp2 = _serve_yaml(
            "- {id: sd15, default: true, hintset: hs, model: {preset: "
            "sd15, seed: 0}}\n"
            f"- {{id: esrgan-x4, task: upscaler, blocks: 23, tile: 128, "
            f"model: {paths['esrgan-x4']}}}\n"
            f"- {{id: swinir-x4, task: upscaler, kind: swinir, tile: 64, "
            f"model: {paths['swinir-x4']}}}\n"
            f"- {{id: hat-x4, task: upscaler, kind: hat, tile: 64, "
            f"model: {paths['hat-x4']}}}\n"
            f"- {{id: background-removal, task: background_removal, "
            f"model: {paths['background-removal']}}}\n"
            f"- {{model_id: smoke-cn, model: {cn_path}}}\n"
            "- {hintset_id: hs, controlnet/depth: {aliases: [depth], "
            "model: '@smoke-cn'}}\n")
        shutil.rmtree(tmp2, ignore_errors=True)
        runs, models = {}, {}
        for eid, task, *_ in table:
            t0 = time.perf_counter()
            runs[eid] = manager.task_pipeline(task, eid)
            torch.cuda.synchronize()
            models[eid] = getattr(runs[eid], "model", None) or \
                runs[eid].models[0]
            emit({"phase": "upscalers", "engine": eid,
                  "load_s": time.perf_counter() - t0,
                  "params": sizes[eid][0], "file_bytes": sizes[eid][1],
                  "model": type(models[eid]).__name__,
                  "dtype": str(models[eid].dtype)})
        status = {s["id"]: (s["ready"], s["weights"])
                  for s in manager.status()}
        emit({"phase": "upscalers", "status": status})
        for eid, *_ in table:
            if status[eid] != (True, "real"):
                failed.append(f"{eid}: status {status[eid]}")

        def measure(name, fn, out_shape, extra=None, profile=False):
            """Warm-up, then the launches, peak memory and the median wall
            of 3 of fn(); a traced call's busy share when ``profile``."""
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _build.reset_launches()
            out = fn()
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.launches.items() if v}
            peak = torch.cuda.max_memory_allocated()
            wall = _median_wall(fn, 3)[0]
            line = {"phase": "upscalers", "run": name, "wall_s": wall,
                    "peak_bytes": peak, "peak_over_weights_bytes":
                        peak - base, "launches": launches,
                    "shape": list(out.shape),
                    "finite": bool(out.isfinite().all()),
                    "min": float(out.min()), "max": float(out.max()),
                    **(extra or {})}
            if profile:
                prof = _device_profile(fn)
                prof["busy_share"] = prof["device_busy_s"] / \
                    prof["traced_wall_s"]
                line.update(prof)
            emit(line)
            failed.extend(f"{name}: {what}" for what, bad in (
                (f"launches {launches}", bool(launches)),
                (f"shape {line['shape']}", line["shape"] != out_shape),
                ("not finite", not line["finite"]),
                ("out of [0, 1]", line["min"] < 0 or line["max"] > 1))
                if bad)
            return out

        # --- background removal at three sizes: unscaled, scaled, scaled
        # and refined by the guided filter
        for name, (h, w) in BG_SIZES.items():
            x = torch.from_numpy(_scene(h, w)).cuda()
            out = measure(f"background_removal_{name}",
                          lambda: runs["background-removal"](x),
                          [1, h, w, 4], {"size": [h, w]}, profile=True)
            alpha = out[..., 3]
            emit({"phase": "upscalers", "check": f"alpha_{name}",
                  "mean": float(alpha.mean()), "std": float(alpha.std())})
            if not torch.equal(out[..., :3], x):
                failed.append(f"background removal {name}: RGB changed")
            del x, out, alpha

        # --- ESRGAN on a 256² RGBA image (16 tiles of 128²) against the
        # model run untiled; SwinIR and HAT on a 128² image
        rgba = torch.from_numpy(np.concatenate([
            _scene(ESRGAN_SIZE, ESRGAN_SIZE),
            _scene(ESRGAN_SIZE, ESRGAN_SIZE)[..., :1]], -1)).cuda()
        pipe = runs["esrgan-x4"]
        tiles = len(pipe.positions(ESRGAN_SIZE, ESRGAN_SIZE)[0])
        s4 = 4 * ESRGAN_SIZE
        tiled = measure("esrgan_tiled", lambda: pipe(rgba),
                        [1, s4, s4, 4], {"tiles": tiles, "tile": pipe.tile})
        with torch.inference_mode():
            direct = measure("esrgan_untiled",
                             lambda: pipe.model(rgba[..., :3]).float(),
                             [1, s4, s4, 3])
        diff = (tiled[..., :3] - direct).abs()
        cells = diff[0].reshape(4, s4 // 4, 4, s4 // 4, 3).mean(
            dim=(1, 3, 4))
        alpha_want = I.rescale(rgba[..., 3:], s4, s4, fit="strict")
        emit({"phase": "upscalers", "check": "esrgan_tiled_vs_untiled",
              "tiles": tiles, "alpha_shape": list(tiled[..., 3:].shape),
              "alpha_max_diff": float((tiled[..., 3:] -
                                       alpha_want.clamp(0, 1)).abs().max()),
              "max_abs_diff": float(diff.max()),
              "mean_abs_diff": float(diff.mean()),
              "cell_mean_max": float(cells.max()),
              "bound": ESRGAN_TILE_CELL_BOUND})
        if tiles != 16:
            failed.append(f"esrgan: {tiles} tiles, expected 16")
        if float(cells.max()) > ESRGAN_TILE_CELL_BOUND:
            failed.append(f"esrgan tiled: a cell {float(cells.max())} off "
                          "the untiled image")
        del tiled, direct, diff
        x = torch.from_numpy(_scene(SR_SIZE, SR_SIZE)).cuda()
        for eid in ("swinir-x4", "hat-x4"):
            measure(eid, lambda: runs[eid](x), [1, 4 * SR_SIZE, 4 * SR_SIZE,
                                               3],
                    {"tiles": len(runs[eid].positions(SR_SIZE,
                                                      SR_SIZE)[0]),
                     "tile": runs[eid].tile,
                     "overlap": runs[eid].overlap})

        # --- the card's models against the same weights in f32 on the CPU
        for eid, _, _, export, load_fn, _ in table:
            _upscaler_vs_cpu(eid, models[eid], load_fn, export, failed)
        _bg_engine_vs_cpu(paths["background-removal"], failed)

        # --- over gRPC: client.py's requests, each against the same work
        # in-process
        ns = _client_builders()
        channel, generate = _grpc_generate(serving.grpc_port)
        size = HINTER_SIZE
        img_np = _mode_inputs(size)[0]
        paths_in = {}
        for name, img in (("hint", img_np[0]),
                          ("small", _scene(SR_SIZE, SR_SIZE)[0])):
            paths_in[name] = os.path.join(tmp, f"{name}.png")
            with open(paths_in[name], "wb") as fh:
                fh.write(I.encode_png(img))
        argv = [REQUEST["prompt"], "-n", REQUEST["negative_prompt"],
                "--host", "localhost:1", "-W", str(size), "-H", str(size),
                "--steps", str(STEPS), "-s", "k_dpmpp_2m", "-S", "61"]
        cases = {
            "esrgan-x4": ["-e", "esrgan-x4", "-i", paths_in["small"]],
            "background-removal": ["-e", "background-removal", "-i",
                                   paths_in["small"]],
            "nobg_depth": ["-e", "sd15", "--hint_from_image",
                           f"nobg:depth:{paths_in['hint']}"]}
        hinted = {"flash_attention": 921, "gn_stats": 1308,
                  "gn_silu_conv3x3": 1308}
        got, diffs = {}, {}
        for name, a in cases.items():
            req = _client_request(ns, argv + a)
            generate(req)                                   # warm-up
            _build.reset_launches()
            t0 = time.perf_counter()
            got[name] = generate(req)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _build.launches.items() if v}
            expect = hinted if name == "nobg_depth" else {}
            emit({"phase": "upscalers", "grpc": name, "wall_s": wall,
                  "shape": list(got[name].shape), "launches": launches,
                  "expected_launches": expect})
            if launches != expect:
                failed.append(f"gRPC {name}: launches {launches} != "
                              f"{expect}")
        small = torch.from_numpy(I.decode_png(I.encode_png(
            _scene(SR_SIZE, SR_SIZE)[0]))).cuda()
        for eid in ("esrgan-x4", "background-removal"):
            want = runs[eid](small)[0].clamp(0, 1).cpu().numpy()
            diffs[eid] = float(np.abs(got[eid] / 255.0 - want).max()) \
                if got[eid].shape == want.shape else float("inf")
        # the nobg hint: client.py's chain (background removal SOLID, the
        # depth adjustment, the mask reapplied as ALPHA) in-process, then
        # the same request with that hint
        req = _client_request(ns, argv + cases["nobg_depth"])
        chain = [p.artifact for p in req.prompt
                 if p.WhichOneof("prompt") == "artifact"][-1].adjustments
        upload = torch.from_numpy(I.decode_png(I.encode_png(img_np[0])))
        hint = adjustments.apply_image_adjustment(upload.cuda(), chain,
                                                  manager, None, 61)
        want = manager.dispatch_view("sd15").pipe(**dict(
            REQUEST, height=size, width=size, seeds=[61],
            output_dtype="uint8", chunk_steps=10,
            stop_event=threading.Event(), hints=[{
                "params": manager.hint_model("depth", "sd15")["params"],
                "kind": "controlnet",
                "image": hint[..., :3].cpu().numpy(), "scale": 1.0}]))
        diffs["nobg_depth"] = int(np.abs(got["nobg_depth"].astype(int) -
                                         want[0].cpu().numpy().astype(int)
                                         ).max())
        emit({"phase": "upscalers", "check": "grpc_equals_in_process",
              "max_diff": diffs, "nobg_hint_shape": list(hint.shape),
              "nobg_alpha_mean": float(hint[..., 3].mean())})
        for name, d in diffs.items():
            if d > (1 if name == "nobg_depth" else 1.0 / 255 + 1e-6):
                failed.append(f"gRPC {name}: {d} off the in-process image")
    finally:
        if channel is not None:
            channel.close()
        if serving is not None:
            serving.stop(0)
        if manager is not None:
            manager.dispatcher.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    emit({"phase": "upscalers", "phase_s": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError("upscalers: " + "; ".join(failed))


# ------------------------------------------ diffusion upscalers, CodeFormer


def _face_indices(model, x):
    """CodeFormer's 256 codebook indices for images x (its idx_pred
    logits' argmax, read by a forward hook) and its output."""
    import torch

    seen = []
    hook = model.idx_pred.register_forward_hook(
        lambda _m, _i, out: seen.append(out.argmax(dim=-1)))
    try:
        with torch.inference_mode():
            out = model(x, 0.5)
    finally:
        hook.remove()
    return seen[0], out


def _diffusion_vs_cpu(eid, yaml_entry, card_up, failed):
    """The card's upscaler (bf16) against a CPU manager's over the same
    checkpoint in f32, at DIFFUSION_CPU_SIZES and DIFFUSION_CPU_STEPS with
    the same noise (the port's generators run on the CPU for either
    device). One line."""
    import torch

    from gyre_tpu_torch.manager.manager import EngineManager

    t0 = time.perf_counter()
    size, steps = DIFFUSION_CPU_SIZES[eid], DIFFUSION_CPU_STEPS[eid]
    x = torch.from_numpy(_scene(size, size))
    manager = EngineManager([yaml_entry], device="cpu",
                            compute_dtype=torch.float32)
    try:
        cpu_up = manager.task_pipeline("upscaler", eid).upscaler
        ref = cpu_up(x, steps=steps).float()
        card = card_up(x.cuda(), steps=steps).float().cpu()
    finally:
        manager.dispatcher.stop()
    err = float((card - ref).abs().max()) if card.shape == ref.shape \
        else float("inf")
    emit({"phase": "diffusion_upscalers", "card_vs_cpu_f32": eid,
          "size": size, "steps": steps, "max_abs_diff": err,
          "mean_abs_diff": float((card - ref).abs().mean()),
          "bound": DIFFUSION_BF16_BOUND, "cpu_std": float(ref.std()),
          "shape": list(card.shape), "seconds": time.perf_counter() - t0})
    if not err <= DIFFUSION_BF16_BOUND:
        failed.append(f"{eid}: {err} off the CPU's f32")
    if float(ref.std()) < 1e-3:
        failed.append(f"{eid}: a flat CPU image")


def phase_diffusion_upscalers():
    """The D4b engines and ToMe (module docstring, 5j)."""
    import os
    import shutil
    import tempfile

    import grpc
    import numpy as np
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.generated import engines_pb2 as epb
    from gyre_tpu_torch.models import codeformer as cf
    from gyre_tpu_torch.models import load
    from gyre_tpu_torch.models.modelset import random_modelset
    from gyre_tpu_torch.ops import images as I
    from gyre_tpu_torch.pipeline import diffusion_upscaler as du

    t_phase = time.perf_counter()
    failed = []
    tmp = tempfile.mkdtemp(prefix="gyre-smoke-diffusion-")
    manager = serving = channel = None
    calls = _upscaler_calls()
    paths_expect = {name: _launches(parts, calls)
                    for name, parts in _upscaler_paths().items()}
    try:
        # --- full-width random models (seed 0, drawn on the card) on disk:
        # the x4 and x2 ModelSets as diffusers directories (f32), CodeFormer
        # in the codeformer.pth layout (bf16)
        t0 = time.perf_counter()
        dirs, sizes = {}, {}
        for eid, cfg in (("upscaler-x4", du.X4_CONFIG),
                         ("upscaler-x2", du.X2_CONFIG)):
            ms = random_modelset(cfg, seed=0, dtype=torch.bfloat16,
                                 device="cuda", engine_id=eid)
            dirs[eid] = os.path.join(tmp, eid)
            load.save_modelset(ms, dirs[eid])
            sizes[eid] = _engine_bytes(ms)
            del ms
        face = cf.random_codeformer(cf.CODEFORMER, 0, "cuda")
        dirs["codeformer"] = os.path.join(tmp, "codeformer.safetensors")
        load.write_safetensors(dirs["codeformer"], {
            k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in cf.state_dict_codeformer(face).items()})
        sizes["codeformer"] = sum(p.numel() for p in face.parameters())
        del face
        emit({"phase": "diffusion_upscalers",
              "checkpoints_s": time.perf_counter() - t0,
              "bytes": {k: v for k, v in sizes.items()}})
        entries = {
            "upscaler-x4": {"id": "upscaler-x4", "task": "upscaler",
                            "kind": "sd-x4", "model": dirs["upscaler-x4"],
                            "steps": X4_STEPS, "noise_level": 20},
            "upscaler-x2": {"id": "upscaler-x2", "task": "upscaler",
                            "kind": "sd-x2", "model": dirs["upscaler-x2"],
                            "steps": X2_STEPS},
            "codeformer": {"id": "codeformer", "task": "face_restore",
                           "model": dirs["codeformer"], "fidelity": 0.5}}
        manager, serving, tmp2 = _serve_yaml(
            "- {id: sd15, default: true, model: {preset: sd15, seed: 0}}\n"
            "- {id: sd15-tome, model: {preset: sd15, seed: 0}, "
            f"options: {{tome_ratio: {TOME_RATIO}}}}}\n" +
            "".join(f"- {json.dumps(e)}\n" for e in entries.values()))
        shutil.rmtree(tmp2, ignore_errors=True)
        runs = {}
        for eid, e in entries.items():
            t0 = time.perf_counter()
            runs[eid] = manager.task_pipeline(e["task"], eid)
            torch.cuda.synchronize()
            emit({"phase": "diffusion_upscalers", "engine": eid,
                  "load_s": time.perf_counter() - t0,
                  "weight_bytes": sizes[eid]})
        status = {s["id"]: (s["ready"], s["weights"])
                  for s in manager.status()}
        emit({"phase": "diffusion_upscalers", "status": status})
        for eid in entries:
            if status[eid] != (True, "real"):
                failed.append(f"{eid}: status {status[eid]}")

        def measure(name, fn, out_shape, expect, extra=None):
            """Warm-up, then launches (against ``expect``), peak memory and
            the median wall of 3 of fn()."""
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _build.reset_launches()
            out = fn()
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.launches.items() if v}
            peak = torch.cuda.max_memory_allocated()
            wall = _median_wall(fn, 3)[0]
            line = {"phase": "diffusion_upscalers", "run": name,
                    "wall_s": wall, "peak_bytes": peak,
                    "peak_over_weights_bytes": peak - base,
                    "launches": launches, "expected_launches": expect,
                    "shape": list(out.shape),
                    "finite": bool(out.isfinite().all()),
                    "min": float(out.min()), "max": float(out.max()),
                    "std": float(out.float().std()), **(extra or {})}
            emit(line)
            failed.extend(f"{name}: {what}" for what, bad in (
                (f"launches {launches} != {expect}", launches != expect),
                (f"shape {line['shape']}", line["shape"] != out_shape),
                ("not finite", not line["finite"]),
                ("out of [0, 1]", line["min"] < 0 or line["max"] > 1),
                ("a flat image", line["std"] < 1e-3)) if bad)
            return out

        # --- each engine on the card: the x4 at X4_SIZE², the x2 at
        # X2_SIZE², CodeFormer at 512² and at FACE_OTHER_SIZE
        x4_in = torch.from_numpy(_scene(X4_SIZE, X4_SIZE)).cuda()
        x2_in = torch.from_numpy(_scene(X2_SIZE, X2_SIZE)).cuda()
        fh, fw = FACE_OTHER_SIZE
        fs = cf.CODEFORMER.img_size
        face_sq = torch.from_numpy(_scene(fs, fs)).cuda()
        face_other = torch.from_numpy(_scene(fh, fw)).cuda()
        measure("upscaler_x4", lambda: runs["upscaler-x4"](x4_in),
                [1, 4 * X4_SIZE, 4 * X4_SIZE, 3],
                paths_expect["upscaler_x4"], {"steps": X4_STEPS})
        measure("upscaler_x2", lambda: runs["upscaler-x2"](x2_in),
                [1, 2 * X2_SIZE, 2 * X2_SIZE, 3],
                paths_expect["upscaler_x2"], {"steps": X2_STEPS})
        measure(f"codeformer_{fs}", lambda: runs["codeformer"](face_sq),
                [1, fs, fs, 3], {})
        measure("codeformer_other", lambda: runs["codeformer"](face_other),
                [1, fh, fw, 3], {}, {"resized_from": [fh, fw]})

        # --- the card's models against the same weights in f32 on the CPU
        for eid in ("upscaler-x4", "upscaler-x2"):
            _diffusion_vs_cpu(eid, entries[eid], runs[eid].upscaler, failed)
        face = runs["codeformer"].models[0]
        cpu_face = cf.load_codeformer(load.read_state_dict(
            dirs["codeformer"]), device="cpu")
        idx, card = _face_indices(face, face_sq)
        idx_ref, ref = _face_indices(cpu_face, face_sq.cpu())
        share = float((idx.cpu() == idx_ref).float().mean())
        diff = (card.cpu() - ref).abs()
        emit({"phase": "diffusion_upscalers", "card_vs_cpu_f32":
              "codeformer", "size": fs, "index_share": share,
              "index_share_bound": FACE_INDEX_SHARE,
              "max_abs_diff": float(diff.max()),
              "mean_abs_diff": float(diff.mean()),
              "mean_bound": FACE_F32_MEAN_BOUND})
        if share < FACE_INDEX_SHARE or \
                not float(diff.mean()) <= FACE_F32_MEAN_BOUND:
            failed.append(f"codeformer vs CPU: index share {share}, mean "
                          f"diff {float(diff.mean())}")
        del cpu_face

        # --- ToMe on SD1.5: the phase-4 request on an engine whose
        # options hold tome_ratio, against the same weights without it
        req = dict(REQUEST, seeds=[71], output_dtype="uint8")
        tome_pipe = manager.dispatch_view("sd15-tome").pipe
        plain_pipe = manager.dispatch_view("sd15").pipe

        def tome_run(**kw):
            return tome_pipe(tome_ratio=TOME_RATIO, **req, **kw)

        size = REQUEST["height"]
        tome_img = measure("sd15_tome", lambda: tome_run().float() / 255,
                           [1, size, size, 3], paths_expect["sd15_tome"],
                           {"tome_ratio": TOME_RATIO})
        plain_wall, plain_img = _median_wall(lambda: plain_pipe(**req), 3)
        chunked = tome_run(chunk_steps=10, stop_event=threading.Event())
        tome_u8 = tome_run()
        tome_diff = int((tome_u8.int() - plain_img.int()).abs().max())
        emit({"phase": "diffusion_upscalers", "check": "tome",
              "plain_wall_s": plain_wall,
              "max_diff_vs_unmerged": tome_diff,
              "chunked_equal": bool(torch.equal(chunked, tome_u8)),
              "merged_tokens": sorted({a[2] for a in calls["tome_unet"][0]
                                       if a[3] != 77})})
        if tome_diff == 0:
            failed.append("ToMe: the image of the unmerged engine")
        if not torch.equal(chunked, tome_u8):
            failed.append("ToMe: the 10-step-chunked run differs")
        del tome_img, chunked

        # --- over gRPC: client.py's requests to each engine and to the
        # ToMe engine, each against the same work in-process
        ns = _client_builders()
        channel, generate = _grpc_generate(serving.grpc_port)
        pngs = {}
        for name, img in (("x4", x4_in), ("x2", x2_in),
                          ("face", face_other)):
            pngs[name] = os.path.join(tmp, f"{name}.png")
            with open(pngs[name], "wb") as f:
                f.write(I.encode_png(img[0].cpu().numpy()))
        argv = [REQUEST["prompt"], "-n", REQUEST["negative_prompt"],
                "--host", "localhost:1", "--steps", str(STEPS),
                "-s", "k_dpmpp_2m", "-S", "71"]
        cases = {"upscaler-x4": (["-e", "upscaler-x4", "-i", pngs["x4"]],
                                 paths_expect["upscaler_x4"]),
                 "upscaler-x2": (["-e", "upscaler-x2", "-i", pngs["x2"]],
                                 paths_expect["upscaler_x2"]),
                 "codeformer": (["-e", "codeformer", "-i", pngs["face"]],
                                {}),
                 "sd15-tome": (["-e", "sd15-tome", "-W", str(size), "-H",
                                str(size)], paths_expect["sd15_tome"])}
        diffs = {}
        for name, (a, expect) in cases.items():
            req_pb = _client_request(ns, argv + a)
            _build.reset_launches()
            t0 = time.perf_counter()
            got = generate(req_pb)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _build.launches.items() if v}
            emit({"phase": "diffusion_upscalers", "grpc": name,
                  "wall_s": wall, "shape": list(got.shape),
                  "launches": launches, "expected_launches": expect})
            if launches != expect:
                failed.append(f"gRPC {name}: launches {launches} != "
                              f"{expect}")
            if name == "sd15-tome":
                want = tome_u8[0].cpu().numpy().astype(int)
                diffs[name] = int(np.abs(got.astype(int) - want).max()) \
                    if got.shape == want.shape else 999
                continue
            img = {"upscaler-x4": x4_in, "upscaler-x2": x2_in,
                   "codeformer": face_other}[name]
            want = runs[name](img).clamp(0, 1)[0].cpu().numpy()
            diffs[name] = float(np.abs(got / 255.0 - want).max()) \
                if got.shape == want.shape else float("inf")
        emit({"phase": "diffusion_upscalers",
              "check": "grpc_equals_in_process", "max_diff": diffs})
        for name, d in diffs.items():
            if d > (1 if name == "sd15-tome" else 1.0 / 255 + 1e-6):
                failed.append(f"gRPC {name}: {d} off the in-process image")
        listed = channel.unary_unary(
            "/gooseai.EnginesService/ListEngines",
            request_serializer=epb.ListEnginesRequest.SerializeToString,
            response_deserializer=epb.Engines.FromString)(
                epb.ListEnginesRequest(task_group=epb.UPSCALE),
                timeout=60).engine
        ready = {e.id: e.ready for e in listed}
        emit({"phase": "diffusion_upscalers", "list_upscalers": ready})
        if ready != {"upscaler-x4": True, "upscaler-x2": True}:
            failed.append(f"ListEngines UPSCALE: {ready}")
    except grpc.RpcError as e:
        failed.append(f"gRPC: {e.code()} {e.details()}")
    finally:
        if channel is not None:
            channel.close()
        if serving is not None:
            serving.stop(0)
        if manager is not None:
            manager.dispatcher.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    emit({"phase": "diffusion_upscalers",
          "phase_s": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError("diffusion upscalers: " + "; ".join(failed))


# ---------------------------------------------------------- CLIP (C6, C7)

# the clip phase's small request, bf16 on the card against f32 on the CPU
# over the same weights, noise and crops (the port draws both on the CPU)
CLIP_CPU_SIZE = 64
CLIP_CPU_STEPS = 2
CLIP_CPU_OPTIONS = {"approx_cutouts": 1, "vae_cutouts": 1}
# the guidance loss's gradient with respect to the latents through the
# card's kernels against the same gradient through the plain twins (same
# bf16 weights and input), as ||kernels - twins|| / ||twins||: the two
# round a forward through the UNet, the VAE decoder and ViT-L/14's 24
# layers in bf16 at different points, and the twins alone are 0.04-0.17
# off the f32 gradient (PERF.md, PR 15). One limit for each sigma checked
# (the ramp's first, the first chunk's end), each set between that
# sigma's reading through the kernels and its K2-cut control's (PERF.md,
# PR 15: 0.150 and 0.372 at sigma 14.6, 0.050 and 0.658 at 1.48); a graph
# with K1 or K2 cut (the controls) must be further off than the limit.
# Also, the kernels' error against the f32 gradient at most
# CLIP_GRAD_F32_RATIO times the twins'
CLIP_GRAD_BOUNDS = (0.22, 0.1)
CLIP_GRAD_F32_RATIO = 1.5
# the guided image on the card (bf16) against the CPU's (f32); and the
# safety scores (cosine minus threshold) of the card's checker against the
# CPU's, f32 on both sides past the tower
CLIP_CPU_BOUND = 0.1
SAFETY_SCORE_BOUND = 2e-2


@contextlib.contextmanager
def _swapped_ops(attention=None, conv=None):
    """The models' attention and fused GN -> SiLU -> conv entries replaced
    (the modules the models call through) for the block; None keeps one."""
    from gyre_tpu_torch.ops import attention as A
    from gyre_tpu_torch.ops import fused_norm_conv as FC

    saved = A.attention, FC.gn_silu_conv3x3
    A.attention = attention or saved[0]
    FC.gn_silu_conv3x3 = conv or saved[1]
    try:
        yield
    finally:
        A.attention, FC.gn_silu_conv3x3 = saved


def _plain_twins():
    """Both entries on their plain versions, on the card."""
    from gyre_tpu_torch.ops import attention as A
    from gyre_tpu_torch.ops import fused_norm_conv as FC

    kernel_attention = A.attention

    def attention(q, k, v, mask=None, scale=None):
        if mask is not None:
            return kernel_attention(q, k, v, mask=mask, scale=scale)
        return A._plain_bthd(q, k, v, scale or q.shape[-1] ** -0.5)

    return _swapped_ops(attention, FC.gn_silu_conv3x3_plain)


def _cut_graph(which: str):
    """The kernels of the models' attention ("attention": K1) or fused
    convs ("conv": K2a + K2b) launched outside their Functions, under
    no_grad: the silently cut graph that the kernels' refusal prevents (a
    control for the gradient check)."""
    import torch

    from gyre_tpu_torch.ops import attention as A
    from gyre_tpu_torch.ops import fused_norm_conv as FC

    kernel_attention = A.attention

    def attention(q, k, v, mask=None, scale=None):
        if mask is not None:
            return kernel_attention(q, k, v, mask=mask, scale=scale)
        with torch.no_grad():
            return A._flash(q, k, v, scale or q.shape[-1] ** -0.5)

    def conv(*args, **kw):
        with torch.no_grad():
            return FC._kernels(*args, **kw)

    return _swapped_ops(attention=attention) if which == "attention" \
        else _swapped_ops(conv=conv)


def _guidance_grad(pipe, seed: int, sigma: float):
    """(the guidance loss's gradient with respect to latents x at
    ``sigma`` through the cond stem, as the guided step takes it, the
    loss): the phase-4 prompt, default cutouts, the pipeline's CLIP model
    and VAE."""
    import torch

    from gyre_tpu_torch.models import vae as vae_mod
    from gyre_tpu_torch.pipeline import clip_guidance as cg

    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((1, 64, 64, 4), generator=gen) * sigma).cuda()
    ctx_u, ctx_g = pipe._contexts(REQUEST["prompt"],
                                  REQUEST["negative_prompt"], 1, True, 0)
    stem = pipe._denoiser(ctx_u, ctx_g, 7.5, False)
    vision, vcfg = pipe.clip_vision()
    target = pipe.clip_text_target(REQUEST["prompt"], 1)
    ms = pipe.ms

    def decode(z):
        return vae_mod.decode(ms.vae_params, ms.config.vae,
                              z.to(pipe.compute_dtype)).float()

    xv = x.requires_grad_()
    loss = cg.guidance_loss(stem(xv, sigma), [seed], vision, vcfg, target,
                            cg.ClipGuidanceConfig(guidance_scale=CLIP_SCALE),
                            vae_decode=decode)
    (grad,) = torch.autograd.grad(loss, xv)
    return grad, float(loss)


def _twin(pipe, device: str, dtype):
    """The pipeline's ModelSet and CLIP model in ``dtype`` on ``device``
    (from bf16 the values widen exactly)."""
    import dataclasses

    import torch

    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(device, dtype) if torch.is_tensor(tree) else tree

    ms = pipe.ms
    twin = UnifiedPipeline(dataclasses.replace(
        ms, unet_params=to(ms.unet_params), vae_params=to(ms.vae_params),
        text_params=to(ms.text_params), device=torch.device(device)),
        compute_dtype=dtype)
    twin._clip.update({k: to(v) for k, v in pipe._clip.items()})
    return twin


def _l2_rel(g, ref) -> float:
    return float((g - ref).float().norm() / ref.float().norm())


def _hot_checker(tower, cfg, emb, flagged, seed: int = 5):
    """A SafetyChecker over ``tower`` with 17 concepts and 3 special-care
    embeddings (random unit vectors) but concepts 0.. set to the
    embeddings of the ``flagged`` images, and every concept threshold
    halfway between 1 and the largest cosine of another image with a
    flagged one: those images flag, the others do not."""
    import torch

    from gyre_tpu_torch.pipeline.safety import SafetyChecker

    gen = torch.Generator().manual_seed(seed)

    def units(n):
        u = torch.randn((n, cfg.projection_dim), generator=gen)
        return u / u.norm(dim=-1, keepdim=True)

    emb = emb.float().cpu()
    concepts = units(17)
    concepts[:len(flagged)] = emb[list(flagged)]
    others = [i for i in range(len(emb)) if i not in flagged]
    near = float((emb[others] @ emb[list(flagged)].T).max())
    cut = torch.full((17,), (1.0 + near) / 2)
    return SafetyChecker(tower, cfg, concepts.cuda(), cut.cuda(),
                         units(3).cuda(), torch.full((3,), 0.5).cuda(),
                         trained=True)


def phase_clip():
    """CLIP guidance, the style hint and the safety checker on full-width
    SD1.5 with ViT-L/14 towers from disk (module docstring, 5k)."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import grpc
    import numpy as np
    import torch

    from gyre_tpu_torch import _build, server
    from gyre_tpu_torch.models import clip, configs, load
    from gyre_tpu_torch.models import t2i_adapter as t2i
    from gyre_tpu_torch.models.modelset import random_tree
    from gyre_tpu_torch.ops import images as I
    from gyre_tpu_torch.pipeline import schedule as sched
    from gyre_tpu_torch.pipeline.safety import SafetyChecker
    from gyre_tpu_torch.services.generate import pb

    t_phase = time.perf_counter()
    failed = []

    def note(line):
        emit({"phase": "clip", "at_s": time.perf_counter() - t_phase,
              **line})

    tmp = tempfile.mkdtemp(prefix="gyre-smoke-clip-")
    manager = channel = None
    servings = []
    expect = {n: {k: v for k, v in _launches(parts, _clip_calls()).items()
                  if v} for n, parts in _clip_paths().items()}
    bf = torch.bfloat16
    try:
        # --- full-width random weights (drawn on the card) on disk: a
        # CLIPModel ViT-L/14 (text and vision, projection 768) with its
        # config.json, TencentARC's style adapter (width 1024, 3 layers, 8
        # tokens, context 768); the checker's ViT-L tower waits for the
        # images it is to flag
        t0 = time.perf_counter()
        tcfg = dataclasses.replace(configs.CLIP_VIT_L, projection_dim=768)
        vcfg = clip.CLIP_VISION_L
        clip_dir = os.path.join(tmp, "clip-vit-large-patch14")
        os.makedirs(clip_dir)
        state = load.export_clip_model_state(
            random_tree(clip.param_specs(tcfg), 0, bf, "cuda"), tcfg,
            clip.random_vision(vcfg, 1, bf, "cuda"), vcfg)
        load.write_safetensors(os.path.join(clip_dir, "model.safetensors"),
                               {k: v.to(bf) for k, v in state.items()})
        with open(os.path.join(clip_dir, "config.json"), "w") as fh:
            json.dump(load.clip_model_config(tcfg, vcfg), fh)
        clip_params = sum(v.numel() for v in state.values())
        style_path = os.path.join(tmp, "t2iadapter_style_sd14v1.safetensors")
        style_state = t2i.export_style_state(t2i.random_style(0, bf, "cuda"))
        load.write_safetensors(style_path, {k: v.to(bf) for k, v in
                                            style_state.items()})
        checker_path = os.path.join(tmp, "safety", "model.safetensors")
        del state
        note({"checkpoints_s": time.perf_counter() - t0,
              "clip_params": clip_params,
              "style_params": sum(v.numel() for v in style_state.values())})
        manager, serving, tmp2 = _serve_yaml(
            f"- {{model_id: smoke-clip, model: {clip_dir}}}\n"
            "- {hintset_id: smoke-style, t2i/style: {aliases: style, "
            f"model: {style_path}}}}}\n"
            "- {id: sd15, default: true, model: {preset: sd15, seed: 0}, "
            'clip: "@smoke-clip", hintset: smoke-style, '
            f"safety_checker: {checker_path}}}\n",
            extra=["--batch_max", str(CLIP_SAFETY_BATCH),
                   "--nsfw_behaviour", "ignore"])
        shutil.rmtree(tmp2, ignore_errors=True)
        servings.append(serving)
        for mode in ("flag", "block"):
            args = server.parse_args(
                ["--grpc_port", "0", "--http_port", "0", "--cache_path",
                 os.path.join(tmp, f"cache-{mode}"), "--nsfw_behaviour",
                 mode])
            servings.append(server.serve(args, manager))
        pipe = manager.dispatch_view("sd15").pipe
        t0 = time.perf_counter()
        vision, loaded_cfg = pipe.clip_vision()
        torch.cuda.synchronize()
        style = manager.hint_model("style", "sd15")
        note({"clip_load_s": time.perf_counter() - t0,
              "clip_model": "real", "vision_cfg": dataclasses.asdict(
                  loaded_cfg), "text_cfg": dataclasses.asdict(
                      pipe._clip["text_cfg"]), "style_kind": style["kind"]})
        if loaded_cfg != vcfg or style["kind"] != "style":
            failed.append(f"loaded CLIP {loaded_cfg}, style {style['kind']}")

        def measure(name, fn, extra=None):
            """One run of fn() (after the guided warm-up): launches against
            expect[name], wall, peak memory, a non-flat finite image."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _build.reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _build.launches.items() if v}
            line = {"run": name, "wall_s": wall,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "peak_over_start_bytes":
                        torch.cuda.max_memory_allocated() - base,
                    "launches": launches, "expected_launches": expect[name],
                    "std": float(out.float().std()), **(extra or {})}
            note(line)
            if launches != expect[name]:
                failed.append(f"{name}: launches {launches} != "
                              f"{expect[name]}")
            if line["std"] < 1.0:
                failed.append(f"{name}: a flat image")
            return out

        # --- in-process: the guided request (20 steps, 10-step chunks),
        # "mixed", no_cutouts "vae", a LoRA-adapted engine, the style hint
        req = dict(REQUEST, seeds=[81], output_dtype="uint8")

        def guided(target=pipe, **kw):
            return target(**req, clip_guidance_scale=CLIP_SCALE,
                          chunk_steps=CLIP_CHUNK,
                          stop_event=threading.Event(), **kw)

        guided()                                     # warm-up
        g_img = measure("guided", guided)
        plain_wall, plain_img = _median_wall(lambda: pipe(**req), 1)
        # the trace of a guided step and a chunk loss (2 steps, 1-step
        # chunks: the 20-step request's ~200k device operations take the
        # profiler minutes to collect)
        prof = _device_profile(lambda: pipe(
            **dict(req, steps=2), clip_guidance_scale=CLIP_SCALE,
            chunk_steps=1, stop_event=threading.Event()))
        note({"run": "guided_traced_2_steps", **prof,
              "device_busy_share": prof["device_busy_s"] /
              prof["traced_wall_s"], "unguided_wall_s": plain_wall,
              "max_diff_vs_unguided": int((g_img.int() -
                                           plain_img.int()).abs().max())})
        if torch.equal(g_img, plain_img):
            failed.append("guided: the unguided image")
        measure("mixed", lambda: guided(
            clip_guidance_options={"guidance_base": "mixed"}))
        measure("no_cutouts_vae", lambda: guided(clip_guidance_options={
            "approx_cutouts": 0, "vae_cutouts": 0, "no_cutouts": "vae"}))
        lora = _adapter_states(configs.SD15)["lora"]
        view = manager.adapted_pipeline("sd15", loras=[(lora, 0.8, "clip")])
        l_img = measure("lora_guided", lambda: guided(view))
        if torch.equal(l_img.cpu(), g_img.cpu()):
            failed.append("lora_guided: the plain engine's image")
        del view
        hint_png = os.path.join(tmp, "style.png")
        with open(hint_png, "wb") as fh:
            fh.write(I.encode_png((_hint_image(512, 512, 3)[0] * 255 + 0.5
                                   ).astype(np.uint8)))
        with open(hint_png, "rb") as fh:
            hint_img = _png_pixels(fh.read())[None] / 255.0
        s_img = measure("style", lambda: pipe(**req, hints=[{
            "kind": "style", "params": style["params"],
            "image": hint_img.astype(np.float32), "scale": 1.0}]))
        if torch.equal(s_img, plain_img):
            failed.append("style: the unhinted image")

        # --- the guidance gradient at the ramp's first and chunk sigmas
        # through the kernels, through the plain twins in bf16 and in f32
        # (the reference), and with the attention or the fused convs cut
        # (controls)
        f32_pipe = _twin(pipe, "cuda", torch.float32)
        ramp = sched.build_sigmas(pipe.schedule, STEPS)
        for sigma, bound in zip((float(ramp[0]), float(ramp[CLIP_CHUNK])),
                                CLIP_GRAD_BOUNDS):
            grads = {"kernels": _guidance_grad(pipe, 81, sigma)}
            with _plain_twins():
                grads["twins"] = _guidance_grad(pipe, 81, sigma)
                grads["f32"] = _guidance_grad(f32_pipe, 81, sigma)
            for which in ("attention", "conv"):
                with _cut_graph(which):
                    grads[f"cut_{which}"] = _guidance_grad(pipe, 81, sigma)
            ref = grads["f32"][0]
            vs_f32 = {k: _l2_rel(g, ref) for k, (g, _) in grads.items()
                      if k != "f32"}
            err = _l2_rel(grads["kernels"][0], grads["twins"][0])
            cuts = {k: _l2_rel(grads[k][0], grads["twins"][0])
                    for k in ("cut_attention", "cut_conv")}
            note({"check": "grad_vs_plain_twins", "sigma": sigma,
                  "loss": {k: v[1] for k, v in grads.items()},
                  "max_abs_grad_f32": float(ref.abs().max()),
                  "l2_rel_vs_twins": err, "cut_l2_rel_vs_twins": cuts,
                  "l2_rel_vs_f32": vs_f32, "max_rel_vs_twins": _errors(
                      grads["kernels"][0], grads["twins"][0])[1],
                  "bound": bound,
                  "f32_ratio_bound": CLIP_GRAD_F32_RATIO})
            if not err <= bound or \
                    not vs_f32["kernels"] <= CLIP_GRAD_F32_RATIO * \
                    vs_f32["twins"] or \
                    not min(cuts.values()) > bound:
                failed.append(f"gradient at sigma {sigma}: {err} off the "
                              f"twins', {vs_f32} off f32 (cut: {cuts})")
            del grads, ref
        del f32_pipe

        # --- a small guided request, bf16 on the card against f32 on the
        # CPU (the same noise and crops), with the unguided one beside it
        twin_pipe = _twin(pipe, "cpu", torch.float32)
        small = dict(REQUEST, height=CLIP_CPU_SIZE, width=CLIP_CPU_SIZE,
                     steps=CLIP_CPU_STEPS, seeds=[82])
        diffs, refs = {}, {}
        t0 = time.perf_counter()
        for name, kw in (("unguided", {}), ("guided", {
                "clip_guidance_scale": CLIP_SCALE,
                "clip_guidance_options": CLIP_CPU_OPTIONS})):
            card = pipe(**small, **kw).float().cpu()
            refs[name] = twin_pipe(**small, **kw)
            diffs[name] = float((card - refs[name]).abs().max())
        note({"card_vs_cpu_f32": "guided_small", "size": CLIP_CPU_SIZE,
              "steps": CLIP_CPU_STEPS, "options": CLIP_CPU_OPTIONS,
              "max_abs_diff": diffs, "bound": CLIP_CPU_BOUND,
              "cpu_guided_vs_unguided": float(
                  (refs["guided"] - refs["unguided"]).abs().max()),
              "seconds": time.perf_counter() - t0})
        if not diffs["guided"] <= CLIP_CPU_BOUND:
            failed.append(f"guided small request: {diffs} off the CPU's")
        del twin_pipe

        # --- over gRPC: client.py's --guidance and --hint style requests
        # (the "ignore" server), each against the in-process image
        ns = _client_builders()
        channel, generate = _grpc_generate(servings[0].grpc_port)
        argv = [REQUEST["prompt"], "-n", REQUEST["negative_prompt"],
                "--host", "localhost:1", "--steps", str(STEPS),
                "-s", "k_dpmpp_2m", "-S", "81"]
        for name, a, want in (
                ("guided", ["--guidance", str(CLIP_SCALE)], g_img),
                ("style", ["--hint", f"style:{hint_png}:1.0:balanced"],
                 s_img)):
            _build.reset_launches()
            t0 = time.perf_counter()
            got = generate(_client_request(ns, argv + a))
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _build.launches.items() if v}
            d = int(np.abs(got.astype(int) - want[0].cpu().numpy()).max())
            note({"grpc": name, "wall_s": wall,
                  "launches": launches, "expected_launches": expect[name],
                  "max_diff_vs_in_process": d})
            if launches != expect[name] or d > 1:
                failed.append(f"gRPC {name}: launches {launches}, {d} off "
                              "the in-process image")

        # --- the safety checker: the batch-8 request's images as served
        # (no check), a ViT-L checker made to flag two of them, written in
        # diffusers' layout and loaded by the manager; its scores on the
        # card against the same file's in f32 on the CPU; then the request
        # under "flag" and under "block"
        req8 = _client_request(ns, argv[:-2] + [
            "--samples", str(CLIP_SAFETY_BATCH)] + sum(
                (["-S", str(900 + i)] for i in range(CLIP_SAFETY_BATCH)),
                []))

        def answers(port):
            ch = grpc.insecure_channel(f"localhost:{port}")
            try:
                arts = _image_artifacts(list(ch.unary_stream(
                    "/gooseai.GenerationService/Generate",
                    request_serializer=pb.Request.SerializeToString,
                    response_deserializer=pb.Answer.FromString)(
                        req8, timeout=600)))
            finally:
                ch.close()
            return [(_png_pixels(a.binary), a.finish_reason) for a in arts]

        served = answers(servings[0].grpc_port)
        imgs = np.stack([p for p, _ in served]).astype(np.float32) / 255.0
        tower = clip.random_vision(vcfg, 2, bf, "cuda")
        probe = SafetyChecker(tower, vcfg, torch.zeros((1, 768)).cuda(),
                              torch.ones(1).cuda())
        hot = _hot_checker(tower, vcfg, probe.embed(imgs),
                           CLIP_SAFETY_FLAGGED)
        os.makedirs(os.path.dirname(checker_path))
        load.write_safetensors(checker_path, {
            k: v.to(bf) if k.startswith("vision_model") else v
            for k, v in hot.state_dict().items()})
        del tower, probe, hot
        card_chk = manager.safety_checker()
        _build.reset_launches()
        scores = card_chk.scores(imgs)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.launches.items() if v}
        cpu_chk = SafetyChecker.load(checker_path, torch.float32, "cpu")
        ref = cpu_chk.scores(imgs)
        flags_card = (scores > 0).any(-1).cpu().numpy()
        flags_cpu = (ref > 0).any(-1).numpy()
        margin = ref.max(dim=-1).values.abs()
        clear = (margin > SAFETY_SCORE_BOUND).numpy()
        score_err = float((scores.cpu() - ref).abs().max())
        note({"check": "safety_card_vs_cpu_f32",
              "trained": card_chk.trained, "launches": launches,
              "expected_launches": expect["safety_check"],
              "max_abs_score_diff": score_err, "bound": SAFETY_SCORE_BOUND,
              "flags_card": flags_card.tolist(),
              "flags_cpu": flags_cpu.tolist(),
              "min_margin": float(margin.min())})
        want_flags = [i in CLIP_SAFETY_FLAGGED
                      for i in range(CLIP_SAFETY_BATCH)]
        if not card_chk.trained or launches != expect["safety_check"] or \
                not score_err <= SAFETY_SCORE_BOUND or \
                (flags_card != flags_cpu)[clear].any() or \
                flags_card.tolist() != want_flags:
            failed.append(f"safety: launches {launches}, scores "
                          f"{score_err}, flags {flags_card.tolist()} / "
                          f"{flags_cpu.tolist()}")
        del cpu_chk
        for mode, serving in zip(("flag", "block"), servings[1:]):
            t0 = time.perf_counter()
            got = answers(serving.grpc_port)
            wall = time.perf_counter() - t0
            reasons = [r for _, r in got]
            same = [bool(np.array_equal(p, q)) for (p, _), (q, _) in
                    zip(got, served)]
            black = [not p.any() for p, _ in got]
            note({"grpc": f"safety_{mode}",
                  "wall_s": wall, "finish_reasons": reasons,
                  "equal_to_unchecked": same, "black": black})
            want_reasons = [pb.FILTER if f else pb.NULL for f in want_flags]
            ok = reasons == want_reasons and all(
                s for s, f in zip(same, want_flags) if not f or
                mode == "flag") and (mode == "flag" or all(
                    b == f for b, f in zip(black, want_flags)))
            if not ok:
                failed.append(f"gRPC safety {mode}: {reasons}, equal "
                              f"{same}, black {black}")
    except grpc.RpcError as e:
        failed.append(f"gRPC: {e.code()} {e.details()}")
    finally:
        if channel is not None:
            channel.close()
        for s in servings:
            s.stop(0)
        if manager is not None:
            manager.dispatcher.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    note({"phase_s": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError("clip: " + "; ".join(failed))


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
                                          "seed": 0}},
         {"id": "esrgan-x4", "task": "upscaler", "blocks": 23,
          "tile": 128}],
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
        # engines' natural size; then base -> refiner -> ESRGAN x4
        server, port = build_server(manager, 0, batch_max=1,
                                    host="localhost")
        channel = grpc.insecure_channel(f"localhost:{port}")

        def chain_request(rid, stages):
            chain = pb.ChainRequest(request_id=rid)
            for sid, engine, start, target in stages:
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
            return chain

        try:
            chain = chain_request("smoke-chain", (
                ("base", "sdxl", None, "refine"),
                ("refine", "sdxl-refiner", 0.34, None)))
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
            # the same chain with ESRGAN x4 (random, 23 blocks) after the
            # refiner: one 4096² image, the launches of the two diffusion
            # stages (ESRGAN launches none), and the image the ESRGAN
            # pipeline makes in-process of the refined one
            up_chain = chain_request("smoke-chain-upscale", (
                ("base", "sdxl", None, "refine"),
                ("refine", "sdxl-refiner", 0.34, "upscale"),
                ("upscale", "esrgan-x4", None, None)))
            _build.reset_launches()
            t0 = time.perf_counter()
            up_answers = list(call(up_chain, timeout=900))
            wall = time.perf_counter() - t0
            launches = dict(_build.launches)
            up = [_png_pixels(a.binary) for a in
                  _image_artifacts(up_answers)]
            want = manager.task_pipeline("upscaler", "esrgan-x4")(
                images[0][None].astype(np.float32) / 255.0)
            want = (want[0] * 255).round().to(torch.uint8).cpu().numpy()
            diff = int(np.abs(up[0].astype(int) - want.astype(int)).max()) \
                if up and up[0].shape == want.shape else None
            emit({"phase": "sdxl", "case": "grpc_chain_upscale",
                  "wall_s": wall,
                  "answers": [a.answer_id for a in up_answers],
                  "shapes": [list(i.shape) for i in up],
                  "launches": launches, "expected_launches": expect,
                  "max_diff_in_process": diff})
            if [i.shape for i in up] != [(4096, 4096, 3)]:
                failed.append("sdxl upscale chain: not one 4096x4096 "
                              "image")
            if launches != expect:
                failed.append(f"sdxl upscale chain: launches {launches} "
                              f"!= {expect}")
            if diff is None or diff > 1:
                failed.append(f"sdxl upscale chain: {diff} levels off the "
                              "in-process ESRGAN image")
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
    """uint8 [H,W,3] (or [H,W,4]) of a PNG written by the port's encoder
    (one zlib stream of filter-0 RGB or RGBA scanlines), so that no image
    library is needed."""
    import struct
    import zlib

    import numpy as np

    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise AssertionError("not a PNG")
    off, idat, width, height, c = 8, b"", 0, 0, 0
    while off < len(data):
        (length,), tag = struct.unpack(">I", data[off:off + 4]), \
            data[off + 4:off + 8]
        chunk = data[off + 8:off + 8 + length]
        if tag == b"IHDR":
            width, height = struct.unpack(">II", chunk[:8])
            c = {b"\x08\x02": 3, b"\x08\x06": 4}.get(chunk[8:10], 0)
            if not c:
                raise AssertionError("PNG is not 8-bit RGB or RGBA")
        elif tag == b"IDAT":
            idat += chunk
        off += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + c * width)
    if raw[:, 0].any():
        raise AssertionError("PNG uses scanline filters")
    return raw[:, 1:].reshape(height, width, c)


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
    # what each phase leaves allocated on the card, once collected (a
    # dropped EngineManager frees its engines at once; the collection guards
    # against a cycle that would keep one)
    for phase in (phase_pool, phase_samplers, phase_modes, phase_adapters,
                  phase_hints,
                  phase_adjust, phase_hinters, phase_upscalers,
                  phase_diffusion_upscalers, phase_clip, phase_sd2,
                  phase_sdxl,
                  phase_serve, phase_http, phase_weights):
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

    rows, mode_rows, cn_rows, c5_rows, adj_rows = [], [], [], [], []
    hint_rows, up_rows, clip_rows, pool_rows = [], [], [], []
    for name, source, replaces in KERNEL_TABLE:
        rs = [r for r in kernels[name] if not r.get("modes") and
              not r.get("controlnet") and not r.get("c5") and
              not r.get("adjust") and not r.get("hinter") and
              not r.get("upscaler") and not r.get("clip") and
              not r.get("pool")]
        adj_rs = [r for r in kernels[name] if r.get("adjust")]
        hint_rs = [r for r in kernels[name] if r.get("hinter")]
        up_rs = [r for r in kernels[name] if r.get("upscaler")]
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
        if adj_rs:                  # K2a/K2b rows only where a shape is new
            adj_rows.append({"name": name, "shapes": len(adj_rs),
                             **summary(adj_rs)})
        if hint_rs:                 # K1 only: no hinter runs K2
            hint_rows.append({"name": name, "shapes": len(hint_rs),
                              **summary(hint_rs)})
        up_rows.append({"name": name, "shapes": len(up_rs),
                        **summary(up_rs)})
        clip_rs = [r for r in kernels[name] if r.get("clip")]
        clip_rows.append({"name": name, "shapes": len(clip_rs),
                          **summary(clip_rs)})
        pool_rs = [r for r in kernels[name] if r.get("pool")]
        if pool_rs:                 # K1 only: tp splits no conv
            pool_rows.append({"name": name, "shapes": len(pool_rs),
                              **summary(pool_rs)})
    emit({"mode_shapes": mode_rows})
    emit({"controlnet_shapes": cn_rows})
    emit({"c5_shapes": c5_rows})
    emit({"adjust_shapes": adj_rows})
    emit({"hinter_shapes": hint_rows})
    emit({"upscaler_shapes": up_rows})
    emit({"c5_paths": {name: _path_sums(kernels, parts)
                       for name, parts in _c5_paths().items()}})
    up_calls = _upscaler_calls()
    emit({"upscaler_paths": {name: _path_sums(kernels, parts, up_calls)
                             for name, parts in _upscaler_paths().items()}})
    emit({"clip_shapes": clip_rows})
    emit({"pool_shapes": pool_rows})
    clip_calls = _clip_calls()
    emit({"clip_paths": {name: _path_sums(kernels, parts, clip_calls)
                         for name, parts in _clip_paths().items()}})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
