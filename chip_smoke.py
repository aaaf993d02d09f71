#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gyre_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON object per line:

  1. env       card name and power limit (nvidia-smi), torch and CUDA
  2. build     nvcc builds every kernel of the path from csrc/ (seconds)
  3. kernels   each hand-written kernel against its plain PyTorch version
               at the SD1.5 main-path shapes: max abs error / max |plain|
               within a stated bound, median times of both
  4. pipeline  UnifiedPipeline on full-width SD1.5 (random weights from a
               seed): 512x512, 20 steps k_dpmpp_2m, CFG 7.5 (parallel),
               bf16, chunk_steps=10 with a stop_event, uint8 on the device.
               Launch counts of one batch-1 call, batch-1 p50, batch-8
               images/s, peak memory
  5. serve     EngineManager + the coalescing dispatcher under concurrent
               requests, then two Generate calls over gRPC

Before the last line it prints the kernels table as one JSON object; the
last line is {"ok": true, "device": {...}}. Any failed check raises and the
script exits non-zero; without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

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


def _timed(fn, warmup: int = 2, iters: int = 10) -> float:
    """Median milliseconds of fn() from CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
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


# main-path shapes of K1 at batch 1 with parallel CFG (2 rows): UNet self
# and cross (Tk=77) attention per level, then the VAE's single-head d=512
ATTN_SHAPES = [
    ("unet_self_64", 2, 8, 4096, 4096, 40),
    ("unet_self_32", 2, 8, 1024, 1024, 80),
    ("unet_self_16", 2, 8, 256, 256, 160),
    ("unet_self_8", 2, 8, 64, 64, 160),
    ("unet_cross_64", 2, 8, 4096, 77, 40),
    ("unet_cross_32", 2, 8, 1024, 77, 80),
    ("unet_cross_16", 2, 8, 256, 77, 160),
    ("unet_cross_8", 2, 8, 64, 77, 160),
    ("vae_mid", 1, 1, 4096, 4096, 512),
]
# representative K2 shapes: (name, B, H=W, C, Co, eps)
CONV_SHAPES = [
    ("unet_64_320_320", 2, 64, 320, 320, 1e-5),
    ("unet_32_960_640", 2, 32, 960, 640, 1e-5),
    ("unet_8_2560_1280", 2, 8, 2560, 1280, 1e-5),
    ("vae_64_512_512", 1, 64, 512, 512, 1e-6),
    ("vae_256_512_256", 1, 256, 512, 256, 1e-6),
    ("vae_512_128_128", 1, 512, 128, 128, 1e-6),
]


def phase_kernels():
    """Each kernel against its plain version on the same inputs."""
    import torch

    from gyre_tpu_torch.ops import attention as A
    from gyre_tpu_torch.ops import fused_norm_conv as FC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"flash_attention": [], "gn_stats": [], "gn_silu_conv3x3": []}
    bf = torch.bfloat16

    def rand(*shape, dtype=bf, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale +
                shift).to(dtype)

    for name, b, h, tq, tk, d in ATTN_SHAPES:
        q, k, v = rand(b, h, tq, d), rand(b, h, tk, d), rand(b, h, tk, d)
        scale = d ** -0.5
        out = A.flash_attention_bhtd(q, k, v, scale)
        ref = A.attention_plain(q, k, v, scale)
        abs_err, err = _errors(out, ref)
        ms = _timed(lambda: A.flash_attention_bhtd(q, k, v, scale))
        plain_ms = _timed(lambda: A.attention_plain(q, k, v, scale))
        row = {"shape": name, "bhtq_tk_d": [b, h, tq, tk, d],
               "max_abs_err": abs_err, "max_abs_err_rel": err,
               "bound": BF16_BOUND, "ms": ms, "plain_ms": plain_ms}
        emit({"phase": "kernels", "kernel": "flash_attention", **row})
        if not err <= BF16_BOUND:
            raise AssertionError(f"flash_attention {name}: error {err}")
        results["flash_attention"].append(row)
        del q, k, v, out, ref

    for name, b, hw, c, co, eps in CONV_SHAPES:
        # per-channel offsets exercise the statistics' cancellation
        x = (torch.randn((b, hw, hw, c), generator=gen, device=dev) +
             torch.randn((c,), generator=gen, device=dev) * 2.0).to(bf)
        gs = rand(c, dtype=torch.float32, scale=0.1, shift=1.0)
        gb = rand(c, dtype=torch.float32, scale=0.1)
        w = rand(3, 3, c, co, scale=(9 * c) ** -0.5)
        cb = rand(co, dtype=torch.float32, scale=0.1)

        a, bb = FC.gn_affine(x, gs, gb, 32, eps)
        a_ref, b_ref = FC.gn_affine_plain(x, gs, gb, 32, eps)
        errs = [_errors(a, a_ref), _errors(bb, b_ref)]
        abs_err_a = max(e[0] for e in errs)
        err_a = max(e[1] for e in errs)
        ms = _timed(lambda: FC.gn_affine(x, gs, gb, 32, eps))
        plain_ms = _timed(lambda: FC.gn_affine_plain(x, gs, gb, 32, eps))
        row = {"shape": name, "bhwc_co": [b, hw, hw, c, co],
               "max_abs_err": abs_err_a, "max_abs_err_rel": err_a,
               "bound": F32_STATS_BOUND,
               "ms": ms, "plain_ms": plain_ms}
        emit({"phase": "kernels", "kernel": "gn_stats", **row})
        if not err_a <= F32_STATS_BOUND:
            raise AssertionError(f"gn_stats {name}: error {err_a}")
        results["gn_stats"].append(row)

        out = FC.affine_silu_conv3x3(x, a_ref, b_ref, w, cb)
        ref = FC.affine_silu_conv3x3_plain(x, a_ref, b_ref, w, cb)
        abs_err, err = _errors(out, ref)
        chain = FC.gn_silu_conv3x3(x, gs, gb, w, cb, groups=32, eps=eps)
        chain_ref = FC.gn_silu_conv3x3_plain(x, gs, gb, w, cb, groups=32,
                                             eps=eps)
        err_chain = _errors(chain, chain_ref)[1]
        ms = _timed(lambda: FC.affine_silu_conv3x3(x, a, bb, w, cb))
        plain_ms = _timed(
            lambda: FC.affine_silu_conv3x3_plain(x, a, bb, w, cb))
        chain_ms = _timed(
            lambda: FC.gn_silu_conv3x3(x, gs, gb, w, cb, groups=32, eps=eps))
        chain_plain_ms = _timed(lambda: FC.gn_silu_conv3x3_plain(
            x, gs, gb, w, cb, groups=32, eps=eps))
        row = {"shape": name, "bhwc_co": [b, hw, hw, c, co],
               "max_abs_err": abs_err, "max_abs_err_rel": err,
               "chain_err_rel": err_chain,
               "bound": BF16_BOUND, "ms": ms, "plain_ms": plain_ms,
               "chain_ms": chain_ms, "chain_plain_ms": chain_plain_ms}
        emit({"phase": "kernels", "kernel": "gn_silu_conv3x3", **row})
        if not (err <= BF16_BOUND and err_chain <= BF16_BOUND):
            raise AssertionError(
                f"gn_silu_conv3x3 {name}: error {err} / chain {err_chain}")
        results["gn_silu_conv3x3"].append(row)
        del x, w, out, ref, chain, chain_ref
    torch.cuda.synchronize()
    return results


# launches of each kernel in one batch-1 call of the main path: the UNet
# runs once per step (20 steps of DPM++ 2M, parallel CFG) with 16
# transformers x 2 attentions and 22 resnets x 2 fused convs; the VAE
# decoder adds 1 attention and 14 resnets x 2 fused convs. CLIP's causal
# attention stays on the plain path. K2a runs once per K2b.
STEPS = 20
EXPECTED_LAUNCHES = {"flash_attention": 32 * STEPS + 1,
                     "gn_stats": 44 * STEPS + 28,
                     "gn_silu_conv3x3": 44 * STEPS + 28}
REQUEST = dict(prompt="a photograph of an astronaut riding a horse",
               negative_prompt="blurry", height=512, width=512, steps=STEPS,
               sampler="k_dpmpp_2m", guidance_scale=7.5)


def phase_pipeline():
    """SD1.5 txt2img through UnifiedPipeline, the serving configuration."""
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.models.modelset import random_preset
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline

    t0 = time.perf_counter()
    ms = random_preset("sd15", seed=0, dtype=torch.bfloat16, device="cuda")
    pipe = UnifiedPipeline(ms, compute_dtype=torch.bfloat16)
    kw = dict(REQUEST, output_dtype="uint8", chunk_steps=10,
              stop_event=threading.Event())

    def run(seeds):
        out = pipe(seeds=list(seeds), **kw)
        torch.cuda.synchronize()
        return out

    run([0])                                             # warm-up
    setup_s = time.perf_counter() - t0

    _build.reset_launches()
    t0 = time.perf_counter()
    img = run([1])
    latencies = [time.perf_counter() - t0]
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
    for s in (2, 3, 4):
        t0 = time.perf_counter()
        run([s])
        latencies.append(time.perf_counter() - t0)
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
           "batch8_s": batch_s, "batch8_images_per_s": 8 / batch_s,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "latent_std": lat_std, "image_mean": float(img.float().mean())}
    emit(out)
    del pipe, ms
    torch.cuda.empty_cache()
    return launches


def _generate_request(seed: int):
    from gyre_tpu_torch.services.generate import pb

    req = pb.Request(engine_id="sd15", request_id=f"smoke-{seed}")
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
    Generate over gRPC when grpcio is installed."""
    import importlib.util

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

        if importlib.util.find_spec("grpc") is None:
            emit({"phase": "grpc", "run": False,
                  "why": "grpcio not installed"})
            return
        phase_grpc(manager)
    finally:
        manager.dispatcher.stop()
        del manager
        torch.cuda.empty_cache()


def phase_grpc(manager):
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
        for seed in (200, 201):
            answers = list(call(_generate_request(seed), timeout=600))
            arts = [a for ans in answers for a in ans.artifacts
                    if a.type == pb.ARTIFACT_IMAGE]
            if len(arts) != 1 or arts[0].mime != "image/png" or \
                    not arts[0].binary.startswith(b"\x89PNG\r\n\x1a\n"):
                raise AssertionError(f"Generate(seed={seed}) returned no "
                                     "PNG artifact")
            sizes.append(len(arts[0].binary))
        emit({"phase": "grpc", "run": True, "requests": 2,
              "png_bytes": sizes, "wall_s": time.perf_counter() - t0})
        channel.close()
    finally:
        server.stop(0).wait()


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
    kernels = phase_kernels()
    launches = phase_pipeline()
    phase_serve()
    # ms / plain_ms: sums of the median times over the phase-3 shapes;
    # max_abs_err: the largest absolute error over those shapes
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": max(r["max_abs_err"] for r in kernels[name]),
         "ms": sum(r["ms"] for r in kernels[name]),
         "plain_ms": sum(r["plain_ms"] for r in kernels[name])}
        for name, source, replaces in KERNEL_TABLE]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
