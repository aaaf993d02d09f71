#!/usr/bin/env python3
"""Sweeps of the hand-written kernels' launch choices on one NVIDIA card.

    python3 kernel_sweep.py [--out FILE] [--only gn_stats,conv,flash]

from the repo's root. Prints one JSON object per line (and appends them to
FILE if given):

  * ``gn_stats``: K2a (csrc/gn_stats.cu) at every phase-3 shape of
    chip_smoke.py (``CONV_SHAPES``, ``GN_BATCH8_SHAPES``) for every
    (slabs, cluster size, block size) its entry takes, beside the wrapper's
    choice
    (``auto``), each held to the plain version within ``F32_STATS_BOUND``;
    keys ``<slabs>x<cluster>x<threads>``;
  * ``gn_stats_ablation``: K2a at five shapes, stopped early: after its
    launch, after its loads and per-thread sums, before it finishes any
    group. Timing only;
  * ``conv_split``: K2b (csrc/gn_silu_conv3x3.cu) at every SD1.5 conv
    shape of chip_smoke.py (``CONV_SHAPES``) with its split-K chosen by
    the kernel (``auto``) and forced to each of 1..16, against cuDNN's
    conv on the activated input;
  * ``conv_ablation``: K2b at four shapes with parts of its main loop
    removed: the weight loads, the halo loads and activation, both, and
    then the products too. Timing only: those variants compute nothing
    meaningful;
  * ``flash_config``: K1 (csrc/flash_attention.cu) at chip_smoke.py's
    attention shapes (``ATTN_SHAPES``) up to head dim 160 for 4 or 8 warps
    x two KV tile lengths, on [B,T,H,D] projections as the models pass
    them, against ``scaled_dot_product_attention``.

A development tool beside chip_smoke.py, not part of the port: the kernels
keep no tuning switches, so each variant is compiled from csrc/ with a
textual substitution into ``build/gyre_tpu_torch/sweep/``; a substitution
whose line is gone from the source stops the sweep with an error. Times
are chip_smoke's ``_timed`` medians; every variant that computes is held
to the plain version within chip_smoke's ``BF16_BOUND`` before it is
timed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

from chip_smoke import (ATTN_SHAPES, BF16_BOUND, CONV_SHAPES,
                        F32_STATS_BOUND, GN_BATCH8_SHAPES, _timed)

ABLATION_SHAPES = ("unet_8_2560_1280", "unet_16_1280_1280",
                   "unet_64_320_320", "vae_128_512_512")
GN_ABLATION_SHAPES = ("unet_8_1280_1280", "unet_16_1280_1280",
                      "unet_32_640_640", "unet_64_320_320",
                      "vae_512_128_128")


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"sweep: {old!r} not found in the kernel source; "
                           "update the substitution")
    return src.replace(old, new)


# K2b main-loop lines the ablations switch off
_SPLIT_AT = "  const auto* xp = static_cast<const __nv_bfloat16*>(x);"
_LOAD_W = "      load_w(j0 + q, tap,"
_ACTIVATE = ("    if (tap >= NSTAGE - 1 && q + 1 < n_chunks)\n"
             "      activate(")
_LOAD_HALO = ("      if (tap == NSTAGE - 1 && q + 1 < n_chunks)\n"
              "        load_halo(")
_PRODUCTS = "    for (int kk = 0; kk < BKC / 16; ++kk)\n      wgmma_n128("


def conv_variants(src: str) -> dict[str, str]:
    """K2b sources: the kernel with a GYRE_SPLIT override, and ablations."""
    split = "#include <cstdlib>\n" + _sub(
        src, _SPLIT_AT,
        '  if (const char* e = getenv("GYRE_SPLIT")) split = atoi(e);\n' +
        _SPLIT_AT)
    no_w = _sub(split, _LOAD_W, "      if (x < NSTAGE) load_w(j0 + q, tap,")

    def no_halo(s):
        s = _sub(s, _ACTIVATE, "    if (false)\n      activate(")
        return _sub(s, _LOAD_HALO, "      if (false)\n        load_halo(")

    neither = no_halo(no_w)
    return {"kernel": split, "no_weight_loads": no_w,
            "no_halo_or_activation": no_halo(split), "neither": neither,
            "neither_nor_products": _sub(
                neither, _PRODUCTS,
                "    for (int kk = 0; kk < 0; ++kk)\n      wgmma_n128(")}


# K2a lines the ablations cut after
_GN_START = "  cluster_arrive_relaxed();\n"
_GN_BLOCK_SUM = "  // over the block's rows: lanes"
_GN_FINISH = "  for (int j = warp; rank + ncl * j < groups; j += kWarps) {"


def gn_variants(src: str) -> dict[str, str]:
    """K2a sources that stop early, at the wrapper's launch: after the
    launch itself, after the loads and per-thread sums, and after the
    cluster's exchange (no group is finished). Timing only."""
    stop = "  if (hw > 0) return;\n"
    return {"launch_only": _sub(src, _GN_START, _GN_START + stop),
            "loads": _sub(src, _GN_BLOCK_SUM, stop + _GN_BLOCK_SUM),
            "no_finish": _sub(src, _GN_FINISH, stop + _GN_FINISH)}


def flash_variant(src: str) -> str:
    """K1 with its (warps, KV tile) chosen by GYRE_NW / GYRE_BK at d <= 160."""
    start = src.index("  // warps and KV tile per head dim")
    end = src.index("#undef GYRE_FLASH")
    table = "".join(
        f"  if (!done && d <= {dp} && nw == {nw} && bk == {bk}) {{\n"
        f"    err = GYRE_FLASH({dp}, {dp}, {bk}, true, {nw});\n"
        f"    done = true;\n  }}\n"
        for dp, bks in ((48, (64, 128)), (80, (64, 128)), (160, (32, 64)))
        for nw in (4, 8) for bk in bks)
    body = ('  const int nw = atoi(getenv("GYRE_NW"));\n'
            '  const int bk = atoi(getenv("GYRE_BK"));\n'
            "  cudaError_t err = cudaErrorInvalidValue;\n"
            "  bool done = false;\n" + table)
    return "#include <cstdlib>\n" + src[:start] + body + src[end:]


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    from gyre_tpu_torch import _build

    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"sweep: {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def _rel_err(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max())


def sweep_gn_stats(libs, emit):
    import torch

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.ops import fused_norm_conv as FC

    fn = _build.library("gn_stats").gyre_gn_stats
    sig = _build.SIGNATURES["gn_stats"]["gyre_gn_stats"]
    for lib in libs.values():
        lib.gyre_gn_stats.argtypes = sig
    # the floor of one launch under chip_smoke's timer: a one-element fill
    emit({"sweep": "gn_stats_floor",
          "fill_1_ms": _timed(lambda: torch.zeros(1, device="cuda"))})
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(n, b, hw, c, eps) for n, b, hw, c, _, eps, _ in CONV_SHAPES]
    shapes += [(n, b, hw, c, eps) for n, b, hw, c, eps, _ in GN_BATCH8_SHAPES]
    for name, b, hw, c, eps in shapes:
        x = (torch.randn((b, hw, hw, c), generator=gen, device="cuda") +
             torch.randn((c,), generator=gen, device="cuda") * 2.0).to(
                 torch.bfloat16)
        gs = 1 + 0.1 * torch.randn((c,), generator=gen, device="cuda")
        gb = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        ab = torch.empty((2, b, c), device="cuda")
        ref = FC.gn_affine_plain(x, gs, gb, 32, eps)

        def call(launch, entry=fn):
            rc = entry(x.data_ptr(), gs.data_ptr(), gb.data_ptr(),
                       ab.data_ptr(), b, hw * hw, c, 32, *launch, eps,
                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"gn_stats: cudaError {rc}")

        times = {}
        for threads in (256, 512, 1024):
            for slabs in FC.gn_slabs(c, 32):
                for cluster in range(1, 17):
                    launch = (slabs, cluster, threads)
                    key = "x".join(map(str, launch))
                    try:
                        call(launch)
                    except RuntimeError as e:  # a launch the entry refuses
                        times[key] = str(e)
                        continue
                    err = max(_rel_err(ab[i], ref[i]) for i in (0, 1))
                    times[key] = (_timed(lambda: call(launch))
                                  if err <= F32_STATS_BOUND else
                                  f"error {err:.3g}")
        ok = {k: v for k, v in times.items() if isinstance(v, float)}
        best = min(ok, key=ok.get)
        auto = "x".join(map(str, FC.gn_launch(b, hw * hw, c, 32)))
        emit({"sweep": "gn_stats", "shape": name, "auto": auto,
              "auto_ms": times[auto], "best": best, "best_ms": ok[best],
              "slabs_x_cluster_ms": times})
        if name in GN_ABLATION_SHAPES:
            launch = FC.gn_launch(b, hw * hw, c, 32)
            emit({"sweep": "gn_stats_ablation", "shape": name,
                  "launch": auto, "kernel": times[auto],
                  **{v: _timed(lambda lib=lib: call(launch,
                                                    lib.gyre_gn_stats))
                     for v, lib in libs.items()}})


def sweep_conv(libs, emit):
    import torch
    import torch.nn.functional as F

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.ops import fused_norm_conv as FC

    sig = _build.SIGNATURES["gn_silu_conv3x3"]["gyre_gn_silu_conv3x3"]
    for lib in libs.values():
        lib.gyre_gn_silu_conv3x3.argtypes = sig
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, hw, c, co, _, _ in CONV_SHAPES:
        x = torch.randn((b, hw, hw, c), generator=gen,
                        device="cuda").to(torch.bfloat16)
        a = 1 + 0.1 * torch.randn((b, c), generator=gen, device="cuda")
        bb = 0.1 * torch.randn((b, c), generator=gen, device="cuda")
        w = (torch.randn((3, 3, c, co), generator=gen, device="cuda") *
             (9 * c) ** -0.5).to(torch.bfloat16)
        cb = 0.1 * torch.randn((co,), generator=gen, device="cuda")
        out = torch.empty((b, hw, hw, co), dtype=torch.bfloat16,
                          device="cuda")
        ref = FC.affine_silu_conv3x3_plain(x, a, bb, w, cb)
        y = F.silu(x.float() * a[:, None, None] + bb[:, None, None]).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cb_bf = cb.to(torch.bfloat16)
        row = {"sweep": "conv_split", "shape": name,
               "library_ms": _timed(lambda: F.conv2d(y, w_cl, cb_bf,
                                                    padding=1))}

        def call(lib):
            rc = lib.gyre_gn_silu_conv3x3(
                x.data_ptr(), a.data_ptr(), bb.data_ptr(), w.data_ptr(),
                cb.data_ptr(), out.data_ptr(), b, hw, hw, c, co,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"gn_silu_conv3x3: cudaError {rc}")

        for split in ("auto", *range(1, 17)):
            if split != "auto" and split > -(-c // 64):
                continue
            if split == "auto":
                os.environ.pop("GYRE_SPLIT", None)
            else:
                os.environ["GYRE_SPLIT"] = str(split)
            call(libs["kernel"])
            err = _rel_err(out, ref)
            row[f"split_{split}"] = (_timed(lambda: call(libs["kernel"]))
                                     if err <= BF16_BOUND else
                                     f"error {err:.3g}")
        os.environ.pop("GYRE_SPLIT", None)
        emit(row)
        if name in ABLATION_SHAPES:
            emit({"sweep": "conv_ablation", "shape": name,
                  **{variant: _timed(lambda lib=lib: call(lib))
                     for variant, lib in libs.items()}})


def sweep_flash(lib, emit):
    import torch
    import torch.nn.functional as F

    from gyre_tpu_torch import _build
    from gyre_tpu_torch.ops import attention as A

    fn = lib.gyre_flash_attention
    fn.argtypes = _build.SIGNATURES["flash_attention"]["gyre_flash_attention"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, h, tq, tk, d, _ in ATTN_SHAPES:
        if d > 160:               # the head-dim-split path has no options
            continue
        q, k, v = (torch.randn((b, t, h * d), generator=gen, device="cuda")
                   .to(torch.bfloat16).view(b, t, h, d)
                   for t in (tq, tk, tk))
        o = torch.empty_like(q)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ref = A.attention_plain(qt, kt, vt, d ** -0.5).transpose(1, 2)

        def strides(t):
            return t.stride(0), t.stride(1), t.stride(2)

        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, h, tq, tk, d, *strides(q), *strides(k), *strides(v),
                    *strides(o), d ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"flash_attention: cudaError {rc}")

        row = {"sweep": "flash_config", "shape": name,
               "library_ms": _timed(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, scale=d ** -0.5))}
        for nw in (4, 8):
            for bk in ((32, 64) if d > 80 else (64, 128)):
                os.environ["GYRE_NW"], os.environ["GYRE_BK"] = str(nw), \
                    str(bk)
                call()
                err = _rel_err(o, ref)
                row[f"warps_{nw}_tile_{bk}"] = (_timed(call)
                                                if err <= BF16_BOUND else
                                                f"error {err:.3g}")
        emit(row)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--only", default="gn_stats,conv,flash",
                    help="comma-separated sweeps to run")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    from gyre_tpu_torch import _build

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    sources = {}
    if "gn_stats" in only:
        sources.update({f"gn_{k}": v for k, v in gn_variants(
            (_build.CSRC / "gn_stats.cu").read_text()).items()})
    if "conv" in only:
        conv_src = (_build.CSRC / "gn_silu_conv3x3.cu").read_text()
        sources.update({f"conv_{k}": v
                        for k, v in conv_variants(conv_src).items()})
    if "flash" in only:
        sources["flash"] = flash_variant(
            (_build.CSRC / "flash_attention.cu").read_text())
    libs = build(sources)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    if "gn_stats" in only:
        sweep_gn_stats({k[len("gn_"):]: v for k, v in libs.items()
                        if k.startswith("gn_")}, emit)
    if "conv" in only:
        sweep_conv({k[len("conv_"):]: v for k, v in libs.items()
                    if k.startswith("conv_")}, emit)
    if "flash" in only:
        sweep_flash(libs["flash"], emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
