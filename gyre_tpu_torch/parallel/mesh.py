"""Device mesh and sharding rules of the port: a pool of torch devices.

Counterpart of gyre_tpu/parallel/mesh.py. The JAX package places an
engine's weights once on a jax Mesh with axes

  dp: data parallel, a merged batch's samples spread over the groups;
  tp: tensor parallel, the transformers' attention heads and MLP hidden
      units split over the devices of a group;

and leaves the placement of rows to XLA. The port has no compiler to do
that, so the mesh is a (dp, tp) grid of ``torch.device``s and both axes are
explicit:

  * ``shard_modelset`` gives one ModelSet per dp group (row of the grid):
    its weights on the row's first device (the group's home), the tp
    leaves split over the row's devices (``models/layers.Shards``), one
    shard a device. The UNet's and the CLIP towers' attentions then run
    each shard's whole heads on its device with K1 at H/tp heads and sum
    the partial out-projections at home (``layers.tp_attention``,
    ``tp_mlp``);
  * ``split_rows`` splits a merged request's samples over the groups
    (parallel/pool.py runs each group on a thread of its own).

A device may appear more than once: two groups on one card, or both shards
of a group on one card (or on the CPU), compute what two cards would.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from ..models import layers as L


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) grid of devices: ``grid[g]`` is dp group g's tp
    devices, its first the group's home."""

    grid: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.grid), "tp": len(self.grid[0])}

    @property
    def devices(self) -> list:
        return [d for row in self.grid for d in row]

    @property
    def homes(self) -> list:
        return [row[0] for row in self.grid]


def make_mesh(devices=None, tp: int | None = None) -> Mesh:
    """A (dp, tp) mesh over ``devices`` (default: every visible CUDA
    device), tp consecutive devices a group. tp defaults to 1: an SD-family
    engine fits one card, so dp is the default scale-out."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    tp = tp or 1
    assert n and n % tp == 0, f"{n} devices not divisible by tp={tp}"
    return Mesh(tuple(tuple(devices[g * tp:(g + 1) * tp])
                      for g in range(n // tp)))


# --------------------------------------------------------- sharding rules

# The JAX package's path rules, on the port's layouts. A JAX linear weight
# is (in, out) and the port's (out, in): JAX's P(None, "tp") (the output
# columns, i.e. heads or hidden units) is the port's dim 0, and its
# P("tp", None) (the input rows of a reducing projection) the port's dim 1.
# A spec is a tuple of axis names or None a dim; () is replicated.
_TP_RULES = [
    # attention projections: heads split (JAX P(None, "tp"))
    (re.compile(r"attn\d?/(q|k|v)/w$"), ("tp", None)),
    (re.compile(r"attn\d?/(q|k|v)/b$"), ("tp",)),
    # output projection: its input split, partial sums added (JAX P("tp",
    # None))
    (re.compile(r"attn\d?/out/w$"), (None, "tp")),
    (re.compile(r"attn\d?/out/b$"), ()),
    # MLP: ff1 by output, ff2 by input; CLIP's fc1 / fc2 likewise
    (re.compile(r"(ff1|fc1)/w$"), ("tp", None)),
    (re.compile(r"(ff1|fc1)/b$"), ("tp",)),
    (re.compile(r"(ff2|fc2)/w$"), (None, "tp")),
    (re.compile(r"(ff2|fc2)/b$"), ()),
]
_ATTN = re.compile(r"attn\d?/(q|k|v|out)/[wb]$")
_GEGLU = re.compile(r"ff1/[wb]$")     # the UNet's [value 4d | gate 4d]


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def leaf_spec(path) -> tuple:
    """The spec of the first rule a leaf's path matches, else ()."""
    s = _path_str(path)
    for pat, spec in _TP_RULES:
        if pat.search(s):
            return spec
    return ()


def param_specs(params, use_tp: bool = True):
    """The spec tree of a params tree (UNet, CLIP or VAE): the first rule
    its path matches, else replicated."""
    return _map(lambda path, _leaf: leaf_spec(path) if use_tp else (),
                params)


def _divisible(leaf, spec: tuple, tp: int) -> bool:
    for dim, axis in enumerate(spec):
        if axis == "tp" and (dim >= leaf.ndim or leaf.shape[dim] % tp != 0):
            return False
    return True


def param_layout(params, tp: int, heads=None):
    """Each leaf's spec once placed on tp devices: the rule's where the
    split dim divides (as JAX's ``param_shardings``) and, unlike JAX's,
    where a split keeps whole heads: an attention leaf is split only when
    ``heads(path)`` (the attention's head count, None when unknown) divides
    by tp, a GEGLU's ff1 only when each half divides. GSPMD may split
    inside a head; the port runs each shard's heads through K1, so a
    single-head attention (the VAE's mid block) or SD2's 5-head level at
    tp = 2 stays replicated."""
    specs = param_specs(params, use_tp=tp > 1)

    def layout(path, leaf):
        spec = _get(specs, path)
        if not spec or not _divisible(leaf, spec, tp):
            return ()
        s = _path_str(path)
        if _ATTN.search(s):
            h = heads(path) if heads is not None else None
            if not h or h % tp:
                return ()
        if _GEGLU.search(s) and (leaf.shape[0] // 2) % tp:
            return ()
        return spec

    return _map(layout, params)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def split_leaf(path, value, spec: tuple, n: int) -> list:
    """``value`` (a tensor or an array of the leaf's layout, a LoRA delta
    too) split into n shards by ``spec``: contiguous blocks of the split
    dim, except a GEGLU ff1's, whose value and gate halves are each split
    so that shard i holds value block i and gate block i."""
    if not spec:
        return [value] * n
    dim = spec.index("tp")
    cat = torch.cat if torch.is_tensor(value) else np.concatenate
    if _GEGLU.search(_path_str(path)):
        half = value.shape[0] // 2
        vals = split_leaf((), value[:half], spec, n)
        gates = split_leaf((), value[half:], spec, n)
        return [cat([a, g], 0) for a, g in zip(vals, gates)]
    size = value.shape[dim] // n
    return [value[(slice(None),) * dim + (slice(i * size, (i + 1) * size),)]
            for i in range(n)]


def shard_params(params, devices, heads=None):
    """A params tree placed on one dp group's ``devices``: a split leaf
    as ``L.Shards`` (shard i contiguous on devices[i]), every other leaf
    on devices[0]. A leaf already on its device is not copied, so groups
    that share a device share their replicated weights."""
    devices = [torch.device(d) for d in devices]
    layout = param_layout(params, len(devices), heads)

    def place(path, leaf):
        spec = _get(layout, path)
        if not spec:
            return leaf.to(devices[0])
        return L.Shards(s.to(d).contiguous() for s, d in
                        zip(split_leaf(path, leaf, spec, len(devices)),
                            devices))

    return _map(place, params)


def unet_heads(ucfg):
    """heads(path) of a UNet tree: each transformer's level's head count
    (None for a config without per-level heads, the k-UNet's)."""
    nh = getattr(ucfg, "num_heads", None)
    if not isinstance(nh, (tuple, list)):
        return None

    def heads(path):
        if path[0] == "down":
            return nh[path[1]]
        if path[0] == "up":
            return nh[ucfg.levels - 1 - path[1]]
        if path[0] == "mid":
            return nh[ucfg.levels - 1]
        return None

    return heads


def shard_modelset(ms, mesh: Mesh) -> list:
    """One ModelSet a dp group: ``ms``'s UNet, VAE and text towers on the
    group's devices (``shard_params``), its device the group's home."""
    cfg = ms.config
    out = []
    for row in mesh.grid:
        text = [shard_params(t, row, lambda _p, c=c: c.num_heads)
                for t, c in zip(ms.text_params, cfg.text_encoders)]
        out.append(dataclasses.replace(
            ms, unet_params=shard_params(ms.unet_params, row,
                                         unet_heads(cfg.unet)),
            vae_params=shard_params(ms.vae_params, row, lambda _p: 1),
            text_params=text, device=row[0]))
    return out


def place(tree, device):
    """A tree of tensors in dicts, lists and tuples (a hint model's params,
    a CLIP model's towers and configs) on ``device``; leaves already there
    are kept, leaves that are not tensors returned as they are."""
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


# ------------------------------------------------------------ the rows

# a request's per-sample arguments: split with the seeds (a leading dim of
# 1 broadcasts to every row and is kept whole)
_ROW_ARGS = ("seeds", "prompt", "negative_prompt", "guidance_scale",
             "init_image", "mask_image", "depth_map")


def row_groups(n: int, dp: int) -> list:
    """Contiguous (start, stop) row ranges of n samples over dp groups,
    the first n % dp one row longer (3 over 2: 2 + 1); empty groups
    dropped."""
    out, start = [], 0
    for g in range(dp):
        size = n // dp + (g < n % dp)
        if size:
            out.append((start, start + size))
        start += size
    return out


def _rows(v, n: int, a: int, b: int):
    if isinstance(v, (str, bytes)) or v is None or np.ndim(v) == 0:
        return v
    if len(v) != n:
        return v
    part = v[a:b]
    return list(part) if isinstance(v, tuple) else part


def split_rows(kwargs: dict, dp: int) -> list:
    """The counterpart of the JAX package's ``shard_batch``: a merged
    request's kwargs as one kwargs a group, each with its contiguous share
    of the samples (``row_groups``) and everything else shared. The JAX
    package defines ``shard_batch`` but never calls it: its dp axis places
    the weights and leaves the rows to XLA; the port's explicit split is
    what that axis names. Samples, not the 2B CFG rows, are split, so both
    CFG halves of a sample stay in its group. Hint images split with the
    rows as well."""
    n = len(kwargs.get("seeds") or [0])
    out = []
    for a, b in row_groups(n, dp):
        kw = dict(kwargs)
        for k in _ROW_ARGS:
            if k in kw:
                kw[k] = _rows(kw[k], n, a, b)
        if kw.get("hints"):
            kw["hints"] = [dict(h, image=_rows(h["image"], n, a, b))
                           for h in kw["hints"]]
        out.append(kw)
    return out
