#!/usr/bin/env python3
"""Sweeps of the hand-written kernels' launch choices on one NVIDIA card.

    python3 kernel_sweep.py [--out FILE] [--only gn_stats,conv,flash]
                            [--parent OLD_gn_silu_conv3x3.cu]

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
    shape of chip_smoke.py (``CONV_SHAPES``) and at the benchmark cells'
    loaded shapes (``cell_conv_shapes``) with its launch chosen by the
    kernel (``auto``) and forced to each tile shape x tile width x split
    (``s<shape>_n<BN>_k<split>``), against cuDNN's conv on the activated
    input;
  * ``conv_ablation``: K2b at six cell shapes with parts of its pipeline
    removed: the weight loads (TMA), the halo loads, the activation, the
    whole halo producer, the weights and the halo producer, and then the
    products too. Timing only: those variants compute nothing meaningful;
  * ``conv_vs``: with ``--parent FILE`` (an older gn_silu_conv3x3.cu),
    that kernel and this one side by side at chip_smoke.py's conv shape
    groups (SD1.5 batch 1, the cells' loaded shapes, the modes', the
    ControlNet's, SD2's and SDXL's, CLIP guidance's), both held to the
    plain version, with cuDNN and the bound beside them;
  * ``flash_config``: K1 (csrc/flash_attention.cu) at chip_smoke.py's
    attention shapes (``ATTN_SHAPES``) up to head dim 160 for 4 or 8 warps
    x two KV tile lengths, on [B,T,H,D] projections as the models pass
    them, against ``scaled_dot_product_attention``.

A development tool beside chip_smoke.py, not part of the port: the kernels
keep no tuning switches, so each variant is compiled from csrc/ with a
textual substitution into ``build/gyre_tpu_torch/sweep/``; a substitution
whose line is gone from the source stops the sweep with an error. Times
are chip_smoke's ``_timed`` medians; every variant that computes is held
to the plain version within chip_smoke's ``BF16_BOUND``, and K2b to its
own bits on a second call, before it is timed. The K2b substitutions are
held to the committed kernel by tests/test_torch_fused_norm_conv.py.
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

ABLATION_SHAPES = ("sd15_unet_b16_64_320_320", "sd15_unet_b16_16_1280_1280",
                   "sd15_unet_b16_8_1280_1280", "sd15_vae_b8_128_512_512",
                   "sd15_vae_b8_512_128_128", "sdxl_unet_b8_32_1280_1280")
GN_ABLATION_SHAPES = ("unet_8_1280_1280", "unet_16_1280_1280",
                      "unet_32_640_640", "unet_64_320_320",
                      "vae_512_128_128")


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"sweep: {old!r} not found in the kernel source; "
                           "update the substitution")
    return src.replace(old, new)


# K2b lines the launch overrides and the ablations change
_SPLIT_AT = "  Plan plan = choose_plan(batch, h, wd, c, co, sms);\n"
_LOAD_W = ("              mbar_expect_tx(full, boxes * kAtomBytes);\n"
           "              for (int bx = 0; bx < boxes; ++bx)\n")
_LOAD_HALO = ("            if (ch_ok && src[i] >= 0)\n"
              "              raw[i] = __ldg(")
_ACTIVATE = "            const uint4 act = silu8(raw[i], a8, b8);\n"
_FILL = ("          for (int i = 0; i < kIters; ++i) {\n"
         "            if ((ht >> 3) + kStep * i >= T::HP) continue;\n")
_PRODUCTS = "          tap_products<BN>(acc, a, b, atoms, first);\n"


def conv_variants(src: str) -> dict[str, str]:
    """K2b sources: the kernel with its launch overridable (GYRE_SHAPE,
    GYRE_BN, GYRE_SPLIT), and ablations of its pipeline."""
    kernel = "#include <cstdlib>\n" + _sub(
        src, _SPLIT_AT, _SPLIT_AT +
        '  if (const char* e = getenv("GYRE_SHAPE")) plan.shape = atoi(e);\n'
        '  if (const char* e = getenv("GYRE_BN")) plan.bn = atoi(e);\n'
        '  if (const char* e = getenv("GYRE_SPLIT")) plan.split = atoi(e);\n')
    # only a block's first NS taps are loaded; later stages complete with a
    # plain arrival on stale weights
    no_w = _sub(kernel, _LOAD_W,
                "              if (t != int(blockIdx.x) || j != j0 || "
                "tap >= NS)\n"
                "                mbar_arrive(full);\n"
                "              else if (mbar_expect_tx(full, boxes * "
                "kAtomBytes), true)\n"
                "              for (int bx = 0; bx < boxes; ++bx)\n")

    def no_loads(s):
        return _sub(s, _LOAD_HALO,
                    _LOAD_HALO.replace("if (", "if (false && ", 1))

    def no_fill(s):
        # each chunk only waits for its buffer and hands it on: nothing is
        # loaded or activated
        return _sub(no_loads(s), _FILL,
                    _FILL.replace("i < kIters", "false", 1))

    neither = no_fill(no_w)
    return {"kernel": kernel, "no_weight_loads": no_w,
            "no_halo_loads": no_loads(kernel),
            "no_activation": _sub(
                kernel, _ACTIVATE, "            const uint4 act = raw[i];\n"),
            "no_halo_or_activation": no_fill(kernel), "neither": neither,
            "neither_nor_products": _sub(neither, _PRODUCTS, "")}


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


def cell_conv_shapes():
    """K2b's distinct shapes in the benchmark's two cells: SD1.5's UNet at
    16 rows (8 images, both CFG halves) and its decode of 8 images, SDXL's
    UNet at 8 rows and its decode of 4: (name, B, H=W, C, Co, launches a
    batch of 20 steps)."""
    from collections import Counter

    from chip_smoke import STEPS, _unet_call_shapes, _vae_call_shapes
    from gyre_tpu_torch.models import configs

    rows = []
    for model, cfg, latent, b in (("sd15", configs.SD15, 64, 8),
                                  ("sdxl", configs.PRESETS["sdxl"], 128, 4)):
        for part, convs, per in (
                ("unet", _unet_call_shapes(cfg.unet, latent, b=2 * b)[1],
                 STEPS),
                ("vae", _vae_call_shapes(cfg.vae, latent, "decoder",
                                         b=b)[1], 1)):
            for (bb, hw, c, co, _), n in Counter(convs).items():
                rows.append((f"{model}_{part}_b{bb}_{hw}_{c}_{co}", bb, hw,
                             c, co, n * per))
    return rows


def conv_groups():
    """chip_smoke.py's conv shape groups, as (name, B, H=W, C, Co) rows
    by group; each group leaves out the shapes of the groups before it."""
    from chip_smoke import (MODE_CONV_SHAPES, _c5_shapes, _clip_shapes,
                            _controlnet_shapes)

    groups = {"sd15_b1": CONV_SHAPES, "cells": cell_conv_shapes(),
              "modes": MODE_CONV_SHAPES,
              "controlnet": _controlnet_shapes()[1],
              "c5": _c5_shapes()[1], "clip": _clip_shapes()[1]}
    seen, out = set(), {}
    for group, rows in groups.items():
        out[group] = []
        for row in rows:
            if tuple(row[1:5]) not in seen:
                seen.add(tuple(row[1:5]))
                out[group].append(tuple(row[:5]))
    return out


class ConvCase:
    """Random inputs of one K2b shape on the card, the plain version's
    output, and calls of a library's entry point on them."""

    def __init__(self, gen, b, hw, c, co):
        import torch
        import torch.nn.functional as F

        from gyre_tpu_torch.ops import fused_norm_conv as FC

        self.dims = (b, hw, c, co)
        self.x = torch.randn((b, hw, hw, c), generator=gen,
                             device="cuda").to(torch.bfloat16)
        self.a = 1 + 0.1 * torch.randn((b, c), generator=gen, device="cuda")
        self.b = 0.1 * torch.randn((b, c), generator=gen, device="cuda")
        self.w = (torch.randn((3, 3, c, co), generator=gen, device="cuda") *
                  (9 * c) ** -0.5).to(torch.bfloat16)
        self.cb = 0.1 * torch.randn((co,), generator=gen, device="cuda")
        self.out = torch.empty((b, hw, hw, co), dtype=torch.bfloat16,
                               device="cuda")
        self.ref = FC.affine_silu_conv3x3_plain(self.x, self.a, self.b,
                                                self.w, self.cb)
        y = F.silu(self.x.float() * self.a[:, None, None] +
                   self.b[:, None, None]).to(torch.bfloat16).permute(
                       0, 3, 1, 2)
        w_cl = self.w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cb_bf = self.cb.to(torch.bfloat16)
        self.library_ms = _timed(lambda: F.conv2d(y, w_cl, cb_bf,
                                                  padding=1))
        del y, w_cl

    def call(self, lib):
        import torch

        b, hw, c, co = self.dims
        rc = lib.gyre_gn_silu_conv3x3(
            self.x.data_ptr(), self.a.data_ptr(), self.b.data_ptr(),
            self.w.data_ptr(), self.cb.data_ptr(), self.out.data_ptr(), b,
            hw, hw, c, co, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gn_silu_conv3x3: cudaError {rc}")

    def checked_ms(self, lib):
        """The call's time, or why not: a launch the entry refuses, an
        error past BF16_BOUND, or two calls that differ in a bit."""
        try:
            self.call(lib)
        except RuntimeError as e:
            return str(e)
        first = self.out.clone()
        err = _rel_err(self.out, self.ref)
        if not err <= BF16_BOUND:
            return f"error {err:.3g}"
        self.call(lib)
        if not bool((first == self.out).all()):
            return "second call differs"
        return _timed(lambda: self.call(lib))


def _sig(libs):
    from gyre_tpu_torch import _build

    sig = _build.SIGNATURES["gn_silu_conv3x3"]["gyre_gn_silu_conv3x3"]
    for lib in libs.values():
        lib.gyre_gn_silu_conv3x3.argtypes = sig


_SMS = 132   # the H100 SXM's SMs: only bounds the sweep's splits


def _conv_tiles(shape, bn, b, hw, co):
    """K2b's output tiles: 16 x 8 pixels of one image (shape 0) or 8 x 8
    of two (shape 1), by ``bn`` channels."""
    tiles = (b * -(-hw // 16) * -(-hw // 8) if shape == 0 else
             -(-b // 2) * -(-hw // 8) ** 2)
    return tiles * -(-co // bn)


def sweep_conv(libs, emit, only=()):
    import torch

    from chip_smoke import conv_bound

    _sig(libs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [r[:5] for r in CONV_SHAPES + cell_conv_shapes()
            if not only or r[0] in only]
    for name, b, hw, c, co in rows:
        case = ConvCase(gen, b, hw, c, co)
        row = {"sweep": "conv_split", "shape": name, "dims": [b, hw, c, co],
               "library_ms": case.library_ms,
               "bound_ms": conv_bound(b * hw * hw, c, co)[0]}
        for key in ("GYRE_SHAPE", "GYRE_BN", "GYRE_SPLIT"):
            os.environ.pop(key, None)
        row["auto"] = case.checked_ms(libs["kernel"])
        for shape in (0, 1):
            if shape == 1 and hw >= 32 and hw % 16 == 0:
                continue           # 8 x 8 tiles of two images: same count
            for bn in (128, 192) if co % 128 == 64 and co > 128 else (128,):
                tiles = _conv_tiles(shape, bn, b, hw, co)
                for split in range(1, 17):
                    # a split fills the SMs the tiles leave idle
                    if split > -(-c // 64) or (split > 1 and
                                               tiles * split > 4 * _SMS):
                        break
                    os.environ.update(GYRE_SHAPE=str(shape), GYRE_BN=str(bn),
                                      GYRE_SPLIT=str(split))
                    row[f"s{shape}_n{bn}_k{split}"] = case.checked_ms(
                        libs["kernel"])
        for key in ("GYRE_SHAPE", "GYRE_BN", "GYRE_SPLIT"):
            os.environ.pop(key, None)
        emit(row)
        if name in ABLATION_SHAPES:
            emit({"sweep": "conv_ablation", "shape": name,
                  **{variant: _timed(lambda lib=lib: case.call(lib))
                     for variant, lib in libs.items()}})
        del case


def sweep_conv_vs(libs, emit):
    """The parent's kernel and this one at every conv shape group."""
    import torch

    from chip_smoke import conv_bound

    _sig(libs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for group, rows in conv_groups().items():
        for name, b, hw, c, co in rows:
            case = ConvCase(gen, b, hw, c, co)
            row = {"sweep": "conv_vs", "group": group, "shape": name,
                   "dims": [b, hw, c, co], "library_ms": case.library_ms,
                   "bound_ms": conv_bound(b * hw * hw, c, co)[0]}
            # in turns: parent, kernel, kernel, parent
            times = {k: [] for k in libs}
            for k in (*libs, *reversed(libs)):
                times[k].append(case.checked_ms(libs[k]))
            for k, ts in times.items():
                row[f"{k}_ms"] = (min(ts) if all(isinstance(t, float)
                                                 for t in ts) else ts)
            emit(row)
            del case


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
                    help="comma-separated sweeps to run (conv_vs with "
                    "--parent)")
    ap.add_argument("--parent", help="an older gn_silu_conv3x3.cu to time "
                    "beside this one (conv_vs)")

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
    if "conv_vs" in only:
        if not args.parent:
            ap.error("conv_vs needs --parent")
        sources["vs_parent"] = open(args.parent).read()
        sources["vs_kernel"] = (_build.CSRC /
                                "gn_silu_conv3x3.cu").read_text()
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
    if "conv_vs" in only:
        sweep_conv_vs({"parent": libs["vs_parent"],
                       "kernel": libs["vs_kernel"]}, emit)
    if "flash" in only:
        sweep_flash(libs["flash"], emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
