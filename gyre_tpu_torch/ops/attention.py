"""Attention: the hand-written flash kernel (K1) and its plain version.

Counterpart of gyre_tpu/ops/attention.py. ``attention`` is the [B,T,H,D]
entry point the models call (layers.attention): every unmasked attention
of CUDA tensors runs ``csrc/flash_attention.cu`` (K1), at every shape,
reading and writing [B,T,H,D] through strides; CPU tensors take
``attention_plain``, and there is no other fallback. The masked path
(CLIP's causal mask) stays plain, as in the JAX package.

Gradients (CLIP guidance differentiates the UNet, the VAE decoder and the
CLIP vision tower): K1 has no backward kernel, as the Pallas kernel has
none. When grad mode is on and an input requires grad, ``attention``
enters ``FlashGrad``, whose forward is K1 and whose backward recomputes
through the query-chunked plain attention (``GRAD_BLOCK_Q`` rows a block,
f32 logits and softmax) and takes its VJP: the JAX package's
``_flash_diff`` rule over ``chunked_attention_bhtd``. A direct launch of
K1 on a tensor that requires grad raises, so a kernel never cuts the
graph silently.
``flash_attention_bhtd`` is the [B,H,T,D] signature of the JAX package,
a transpose over ``attention``. The JAX package's TPU dispatch thresholds
were measured on a TPU and are not carried over.
"""

from __future__ import annotations

import math

import torch

from .. import _build

MAX_HEAD_DIM = 512
# query rows a block of the backward recompute (the JAX package's)
GRAD_BLOCK_Q = 512


def wants_grad(*tensors) -> bool:
    """Whether a call on these tensors must keep the autograd graph."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_graph(name: str, *tensors):
    """Raise when a kernel launch would cut the autograd graph: its output
    has no grad_fn, so a caller's gradient would silently skip it."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and a kernel launch would cut "
            "the autograd graph; call the public entry point, which runs "
            "the kernel under its recompute backward")


def attention_plain(q, k, v, scale: float):
    """softmax(q k^T * scale) v, [B,H,T,D]; logits and softmax in f32,
    probabilities cast to v's dtype for the second product (the JAX
    package's _ref_attention)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _check_flash_inputs(q, k, v):
    """Raise on what K1 does not take: q, k, v are [B,T,H,D] with any
    strides, as long as the head dim is unit-stride and every row starts
    16-byte aligned."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash attention {name} is on {t.device}, "
                             "expected a CUDA tensor")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash attention {name} is {t.dtype}, "
                             "expected torch.bfloat16")
        if t.dim() != 4:
            raise ValueError(f"flash attention: {name} must be 4-D, got "
                             f"shape {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash attention: {name}'s head dim must be "
                             f"unit-stride, got strides {t.stride()}")
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"flash attention: {name}'s rows must start "
                             f"16-byte aligned, got strides {t.stride()}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or \
            k.shape[3] != d:
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash attention: head dim {d} must be a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}")
    if not q.device == k.device == v.device:
        raise ValueError("flash attention: q, k, v on different devices")


def _flash(q, k, v, scale: float):
    """K1 on [B,T,H,D] q, k, v; the output is [B,Tq,H,D], contiguous,
    written by the kernel through its strides."""
    refuse_graph("flash attention", q, k, v)
    _check_flash_inputs(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)

    def strides(t):           # (batch, token, head), in elements
        return t.stride(0), t.stride(1), t.stride(2)

    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.gyre_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[3],
            *strides(q), *strides(k), *strides(v), *strides(out),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    _build.count_launch("flash_attention")
    return out


def _plain_bthd(q, k, v, scale: float):
    """attention_plain on [B,T,H,D] tensors."""
    return attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), scale).transpose(1, 2)


def attention_vjp(q, k, v, scale: float, grad, needs=(True, True, True),
                  block_q: int = GRAD_BLOCK_Q):
    """(dq, dk, dv) of the plain attention at [B,T,H,D] q, k, v against the
    output cotangent ``grad``, recomputed a block of ``block_q`` query rows
    at a time, so the recompute holds one [B,H,block_q,Tk] f32 tile, not
    the whole logits; a gradient not in ``needs`` is None. dk and dv are
    summed over the blocks in f32."""
    tq = q.shape[1]
    dq = torch.empty_like(q) if needs[0] else None
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device) \
        if needs[1] else None
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device) \
        if needs[2] else None
    with torch.enable_grad():
        kk = k.detach().requires_grad_(needs[1])
        vv = v.detach().requires_grad_(needs[2])
        for i in range(0, tq, block_q):
            qi = q[:, i:i + block_q].detach().requires_grad_(needs[0])
            out = _plain_bthd(qi, kk, vv, scale)
            wrt = [t for t, n in zip((qi, kk, vv), needs) if n]
            got = iter(torch.autograd.grad(out, wrt,
                                           grad[:, i:i + block_q]))
            if needs[0]:
                dq[:, i:i + block_q] = next(got)
            if needs[1]:
                dk += next(got).float()
            if needs[2]:
                dv += next(got).float()
    return (dq, None if dk is None else dk.to(k.dtype),
            None if dv is None else dv.to(v.dtype))


class FlashGrad(torch.autograd.Function):
    """K1 with the JAX package's recompute backward: the forward is
    ``forward(q, k, v, scale)`` (K1, ``_flash``; the tests give it the
    plain attention on the CPU, so that the backward runs there), the
    backward ``attention_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, forward):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_vjp(q, k, v, ctx.scale, grad.to(q.dtype),
                                   ctx.needs_input_grad[:3])
        return dq, dk, dv, None, None


def flash_attention_bhtd(q, k, v, scale: float):
    """Flash attention, [B,H,Tq,D] x [B,H,Tk,D] -> [B,H,Tq,D] (the JAX
    package's signature): ``attention`` on the transposed views, so K1
    sees one layout, [B,T,H,D] through strides. The result is a view of
    attention's contiguous [B,Tq,H,D] output."""
    return attention(q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), scale=scale).transpose(1, 2)


def attention(q, k, v, mask=None, scale: float | None = None):
    """Multi-head attention, [B,T,H,D] layout (models/layers contract).

    mask: optional bool tensor broadcastable to [B,H,Tq,Tk], True = keep.
    Unmasked attention of CUDA tensors runs K1 on the [B,T,H,D] tensors as
    they are (no layout copies), under FlashGrad when a gradient is wanted;
    the output is [B,Tq,H,D], contiguous."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if mask is None and q.device.type != "cpu":
        if wants_grad(q, k, v):
            return FlashGrad.apply(q, k, v, scale, _flash)
        return _flash(q, k, v, scale)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if mask is None:
        out = attention_plain(qt, kt, vt, scale)
    else:
        logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * \
            scale
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs.to(vt.dtype), vt)
    return out.transpose(1, 2)
