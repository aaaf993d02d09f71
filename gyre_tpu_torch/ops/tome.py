"""Token merging (ToMe) for the UNet's self-attention, on torch tensors.

Counterpart of gyre_tpu/ops/tome.py, the same static-shape form: a fixed
merge count r, bipartite soft matching between a strided destination grid
(every ``stride``-th token) and the other tokens (the sources), the r
sources most similar to their best destination averaged into it, and an
exact unmerge after the attention (a merged source takes its
destination's output, a kept one its own).

The similarities and the averages are computed in f32 whatever x's dtype
(the JAX package computes them in x's), so bf16 rounding adds no ties.
The merged tokens come out of one ``torch.cat``: contiguous, so the flash
kernel (K1) reads their projections with the strides it requires.

Ties: ``jax.lax.top_k`` breaks them by the lower index, ``torch.topk``
does not promise an order. Where two sources are equally similar at the
r-th place the two packages may merge different ones; where they do not
tie, the merge and unmerge are the JAX package's.
"""

from __future__ import annotations

import torch


def _bipartite_sets(n: int, stride: int, device):
    """dst = every ``stride``-th token (the grid anchors), src = the rest."""
    idx = torch.arange(n, device=device)
    dst = (idx % stride) == 0
    return idx[dst], idx[~dst]


def _rows(idx, c: int):
    """[B, k] token indices as gather/scatter indices over [B, k, C]."""
    return idx[..., None].expand(-1, -1, c)


def merge(x, r: int, stride: int = 2):
    """x [B,N,C] -> (merged [B, N-r, C], info for ``unmerge``): the r
    source tokens most similar to their best destination are averaged
    into it; the other sources pass through, in their order, after the
    destinations."""
    b, n, c = x.shape
    dst_idx, src_idx = _bipartite_sets(n, stride, x.device)
    n_dst, n_src = dst_idx.numel(), src_idx.numel()
    r = min(r, n_src - 1)

    xf = x.float()
    xn = xf / (torch.linalg.vector_norm(xf, dim=-1, keepdim=True) + 1e-6)
    sim = torch.einsum("bsc,bdc->bsd", xn[:, src_idx], xn[:, dst_idx])
    best_sim, best_dst = sim.max(dim=-1)                  # [B, n_src]
    merge_rank = torch.topk(best_sim, r, dim=-1).indices  # [B, r]
    merged_mask = torch.zeros((b, n_src), dtype=torch.bool, device=x.device)
    merged_mask.scatter_(1, merge_rank, True)

    src_vals, dst_vals = xf[:, src_idx], xf[:, dst_idx]
    w = merged_mask.float()
    add = torch.zeros((b, n_dst, c), device=x.device).scatter_add_(
        1, _rows(best_dst, c), src_vals * w[..., None])
    cnt = torch.zeros((b, n_dst), device=x.device).scatter_add_(
        1, best_dst, w)
    new_dst = (dst_vals + add) / (1.0 + cnt[..., None])

    # the kept sources, compacted to the front in their order
    keep_idx = torch.argsort(merged_mask.to(torch.uint8), dim=-1,
                             stable=True)[:, :n_src - r]
    kept = torch.gather(src_vals, 1, _rows(keep_idx, c))
    merged = torch.cat([new_dst, kept], dim=1).to(x.dtype)
    info = {"n": n, "dst_idx": dst_idx, "src_idx": src_idx,
            "best_dst": best_dst, "merged_mask": merged_mask,
            "keep_idx": keep_idx}
    return merged, info


def unmerge(out, info):
    """[B, N-r, C] -> [B, N, C]: a merged source copies its destination's
    output, a kept token goes back to its own place."""
    dst_idx, src_idx = info["dst_idx"], info["src_idx"]
    b, _, c = out.shape
    n_dst = dst_idx.numel()
    dst_out, kept_out = out[:, :n_dst], out[:, n_dst:]
    full_src = torch.gather(dst_out, 1, _rows(info["best_dst"], c))
    full_src = full_src.scatter(1, _rows(info["keep_idx"], c), kept_out)
    canvas = torch.empty((b, info["n"], c), dtype=out.dtype,
                         device=out.device)
    canvas[:, dst_idx] = dst_out
    canvas[:, src_idx] = full_src
    return canvas


def merge_count(n: int, ratio: float, stride: int = 2) -> int:
    """The tokens ``tome_self_attention`` merges out of n at ``ratio`` (0:
    none): that fraction of the sources, at most 0.9 of them."""
    if ratio <= 0:
        return 0
    n_src = n - (n + stride - 1) // stride
    r = int(n_src * min(ratio, 0.9))
    return min(r, n_src - 1) if r >= 1 else 0


def tome_self_attention(attn_fn, x, ratio: float, stride: int = 2):
    """attn_fn(tokens) -> tokens run on a ToMe-reduced token set; ratio:
    the fraction of the source tokens to merge (0 disables)."""
    r = merge_count(x.shape[1], ratio, stride)
    if r < 1:
        return attn_fn(x)
    merged, info = merge(x, r, stride)
    return unmerge(attn_fn(merged), info)
