"""Attention: the hand-written flash kernel (K1) and its plain version.

Counterpart of gyre_tpu/ops/attention.py. ``flash_attention_bhtd`` runs
``csrc/flash_attention.cu`` on CUDA tensors and ``attention_plain`` on CPU
tensors; there is no other fallback. ``attention`` is the [B,T,H,D] entry
point the models call (layers.attention): every unmasked attention goes to
K1, at every shape, and the masked path (CLIP's causal mask) stays plain,
as in the JAX package. The JAX package's TPU dispatch thresholds were
measured on a TPU and are not carried over; where the plain version is
faster on the H100 is for measurement to decide.
"""

from __future__ import annotations

import math

import torch

from .. import _build

MAX_HEAD_DIM = 512


def attention_plain(q, k, v, scale: float):
    """softmax(q k^T * scale) v, [B,H,T,D]; logits and softmax in f32,
    probabilities cast to v's dtype for the second product (the JAX
    package's _ref_attention)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _check_flash_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, f"flash attention {name}", torch.bfloat16)
        if t.dim() != 4:
            raise ValueError(f"flash attention: {name} must be [B,H,T,D], "
                             f"got shape {tuple(t.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h or \
            k.shape[3] != d:
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash attention: head dim {d} must be a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}")
    if not q.device == k.device == v.device:
        raise ValueError("flash attention: q, k, v on different devices")


def flash_attention_bhtd(q, k, v, scale: float):
    """Flash attention, [B,H,Tq,D] x [B,H,Tk,D] -> [B,H,Tq,D].

    CUDA tensors go through the K1 kernel (bf16, contiguous, D a multiple
    of 8 up to 512; anything else raises). CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    _check_flash_inputs(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.gyre_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, tq, tk, d, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    _build.launches["flash_attention"] += 1
    return out


def attention(q, k, v, mask=None, scale: float | None = None):
    """Multi-head attention, [B,T,H,D] layout (models/layers contract).

    mask: optional bool tensor broadcastable to [B,H,Tq,Tk], True = keep."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    if mask is None:
        out = flash_attention_bhtd(qt, kt, vt, scale)
    else:
        logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * \
            scale
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs.to(vt.dtype), vt)
    return out.transpose(1, 2)
