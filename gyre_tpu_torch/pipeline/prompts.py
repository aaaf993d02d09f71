"""Weighted / long prompt machinery on torch tensors.

Counterpart of gyre_tpu/pipeline/prompts.py: the A1111 attention dialect
(``(word)`` x1.1, ``[word]`` /1.1, ``(word:1.25)``, ``\\(`` literals),
prompts past 77 tokens as re-encoded chunks stitched by their bos/eos, and
per-token weighting with the mean-norm restore.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

CHUNK = 75  # tokens per window between bos/eos

_ATTN_RE = re.compile(r"""
\\\(|\\\)|\\\[|\\]|\\\\|\\|\(|\[|:\s*([+-]?[.\d]+)\s*\)|\)|]|[^\\()\[\]:]+|:
""", re.X)


def parse_attention(text: str) -> list[tuple[str, float]]:
    """Parse A1111 attention syntax into [(fragment, weight)]."""
    out: list[list] = []
    round_stack: list[int] = []
    square_stack: list[int] = []

    def multiply(start, mult):
        for item in out[start:]:
            item[1] *= mult

    for m in _ATTN_RE.finditer(text):
        tok = m.group(0)
        w = m.group(1)
        if tok.startswith("\\"):
            out.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(out))
        elif tok == "[":
            square_stack.append(len(out))
        elif w is not None and round_stack:
            multiply(round_stack.pop(), float(w))
        elif tok == ")" and round_stack:
            multiply(round_stack.pop(), 1.1)
        elif tok == "]" and square_stack:
            multiply(square_stack.pop(), 1.0 / 1.1)
        else:
            out.append([tok, 1.0])
    for pos in round_stack:
        multiply(pos, 1.1)
    for pos in square_stack:
        multiply(pos, 1.0 / 1.1)
    if not out:
        out = [["", 1.0]]
    merged: list[list] = []
    for frag, weight in out:
        if merged and abs(merged[-1][1] - weight) < 1e-9:
            merged[-1][0] += frag
        else:
            merged.append([frag, weight])
    return [(f, w) for f, w in merged]


@dataclass(frozen=True)
class Fragment:
    text: str
    weight: float = 1.0


@dataclass(frozen=True)
class WeightedPrompt:
    """One prompt as weighted fragments."""

    fragments: tuple[Fragment, ...]

    @classmethod
    def parse(cls, text: str):
        return cls(tuple(Fragment(t, w) for t, w in parse_attention(text)))


def tokenize_weighted(tokenizer, prompt: WeightedPrompt,
                      max_chunks: int = 3
                      ) -> tuple[np.ndarray, np.ndarray, int]:
    """-> (ids [n_chunks, 77], weights [n_chunks, 77], n_chunks)."""
    ids: list[int] = []
    weights: list[float] = []
    for frag in prompt.fragments:
        t = tokenizer.encode(frag.text)
        ids.extend(t)
        weights.extend([frag.weight] * len(t))
    ids = ids[:CHUNK * max_chunks]
    weights = weights[:CHUNK * max_chunks]
    n_chunks = max(1, -(-len(ids) // CHUNK))
    out_ids = np.full((n_chunks, CHUNK + 2), tokenizer.pad, np.int64)
    out_w = np.ones((n_chunks, CHUNK + 2), np.float32)
    out_ids[:, 0] = tokenizer.bos
    for c in range(n_chunks):
        seg = ids[c * CHUNK:(c + 1) * CHUNK]
        out_ids[c, 1:1 + len(seg)] = seg
        out_ids[c, 1 + len(seg)] = tokenizer.eos
        out_w[c, 1:1 + len(seg)] = weights[c * CHUNK:(c + 1) * CHUNK]
    return out_ids, out_w, n_chunks


def stitch_weights(weights: np.ndarray) -> np.ndarray:
    """[n_chunks, 77] -> [n_chunks*75+2], aligned with the stitched
    embeddings (first chunk's bos, every chunk's middle, last chunk's eos)."""
    return np.concatenate(
        [weights[0, :1], weights[:, 1:-1].reshape(-1), weights[-1, -1:]])


def _pad_chunks(tokenizer, ids: np.ndarray, w: np.ndarray,
                to_chunks: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad (ids, weights) with empty bos/eos chunks up to `to_chunks`."""
    extra = to_chunks - ids.shape[0]
    if extra <= 0:
        return ids, w
    pad_ids = np.full((extra, CHUNK + 2), tokenizer.pad, np.int64)
    pad_ids[:, 0] = tokenizer.bos
    pad_ids[:, 1] = tokenizer.eos
    return (np.concatenate([ids, pad_ids]),
            np.concatenate([w, np.ones((extra, CHUNK + 2), np.float32)]))


def encode_weighted_prompts_batch(encode_ids, tokenizer, prompt_list,
                                  pad_to_chunks: int = 1,
                                  max_chunks: int = 3, device="cpu"):
    """Encode a list of prompts through ONE tower call: every prompt padded
    to the same chunk count, stitched and weighted per row.

    encode_ids: [n, 77] int64 tensor -> [n, 77, D] (tower + layer pick).
    Returns [B, T, D], T = chunks*75 + 2."""
    chunks = max(int(pad_to_chunks), 1)
    ids_l, w_l = [], []
    for p in prompt_list:
        ids, w, n = tokenize_weighted(tokenizer, p, max_chunks)
        if n > chunks:
            raise ValueError(f"prompt needs {n} chunks > pad_to_chunks="
                             f"{chunks}; compute chunk_count over the "
                             f"whole batch first")
        ids, w = _pad_chunks(tokenizer, ids, w, chunks)
        ids_l.append(ids)
        w_l.append(stitch_weights(w))
    b = len(prompt_list)
    emb = encode_ids(torch.from_numpy(np.concatenate(ids_l)).to(device))
    d = emb.shape[-1]
    emb = emb.reshape(b, chunks, CHUNK + 2, d)
    middle = emb[:, :, 1:-1].reshape(b, chunks * CHUNK, d)
    stitched = torch.cat([emb[:, 0, :1], middle, emb[:, -1, -1:]], dim=1)
    w = torch.from_numpy(np.stack(w_l)).to(device)            # [b, T]
    prev = stitched.float().abs().mean(dim=(1, 2), keepdim=True)
    out = stitched * w[:, :, None].to(stitched.dtype)
    new = out.float().abs().mean(dim=(1, 2), keepdim=True)
    return out * (prev / new.clamp_min(1e-8)).to(out.dtype)

