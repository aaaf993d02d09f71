"""LoRA / LyCORIS / textual inversion as functional weight transforms.

Counterpart of gyre_tpu/pipeline/lora.py. Every adapter is a transform of
the params tree, W' = W + scale * rebuild(delta), applied once per
(engine, adapter set) and cached by the engine manager: the models run
unchanged on the folded weights, so an adapted request launches the same
kernels as a plain one.

Formats (detect_lora_format):
  * kohya:      lora_unet_*/lora_te_* with .lora_up/.lora_down/.alpha
  * diffusers:  unet.*.lora_A/lora_B (peft) or *_lora.up/down
  * LyCORIS:    hada_w1_a/b + hada_w2_a/b (LoHa), lokr_w1/w2 (LoKr),
                diff (full)

The module-name resolvers, the grouping and the delta rebuild are the JAX
package's, host numpy in float32 (the port's params tree has the JAX
package's paths). ``apply_lora`` puts each delta into the layout of the
leaf it lands on, by the leaf's ``Spec.kind``: linear (out, in) and conv
OIHW take the checkpoint's torch layout as it is (SD2's and SDXL's linear
``proj_in``/``proj_out`` take 2-D deltas, and a 1x1-conv delta's only
tap), the fused resnet convs (``conv_hwio``) take it permuted to HWIO.
It runs in two halves: the host work (``lora_deltas``: rebuild, layout,
scale) and the device adds (``fold_deltas``), so that a server can keep
the first off the thread that owns the card. The fold never writes into a
tensor: a touched leaf is a new tensor, and the dicts and lists along its
path are new, while every other subtree is shared with the base tree.
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np
import torch

from ..models import layers as L

# ------------------------------------------------------- format detection


def detect_lora_format(state: dict) -> str:
    keys = list(state)
    if any(".hada_w1_a" in k or ".lokr_w1" in k for k in keys):
        return "lycoris"
    if any(k.startswith(("lora_unet_", "lora_te")) for k in keys):
        return "kohya"
    if any(".lora_A." in k or ".lora_B." in k or ".lora.up." in k or
           ".lora_linear_layer." in k or "_lora.up" in k for k in keys):
        return "diffusers"
    if any(k.endswith(":up") or "<s>" in k for k in keys):
        return "cloneofsimo"
    return "unknown"


# --------------------------------------------------- module-name resolution

_KOHYA_UNET_RE = re.compile(
    r"lora_unet_(down_blocks|up_blocks|mid_block)_?(\d)?_"
    r"(attentions|resnets)_(\d)_(.*)")


def _kohya_unet_path(name: str):
    """kohya module name -> path into the unet tree, or None."""
    m = _KOHYA_UNET_RE.match(name)
    if not m:
        return None
    section, lvl, kind, idx, rest = m.groups()
    base = {"down_blocks": ("down",), "up_blocks": ("up",),
            "mid_block": ("mid",)}[section]
    if section == "mid_block":
        if kind == "attentions":
            head = ("mid", "attn")
        else:
            head = ("mid", "res1" if idx == "0" else "res2")
    else:
        head = base + (int(lvl), "attns" if kind == "attentions" else
                       "resnets", int(idx))
    tail = _module_tail(rest)
    if tail is None:
        return None
    return head + tail


def _module_tail(rest: str):
    """transformer_blocks_0_attn1_to_q -> ('blocks', 0, 'attn1', 'q')."""
    m = re.match(r"transformer_blocks_(\d+)_(attn[12])_to_(q|k|v|out_0)",
                 rest)
    if m:
        tgt = m.group(3).replace("out_0", "out")
        return ("blocks", int(m.group(1)), m.group(2), tgt)
    m = re.match(r"transformer_blocks_(\d+)_ff_net_0_proj", rest)
    if m:
        return ("blocks", int(m.group(1)), "ff1")
    m = re.match(r"transformer_blocks_(\d+)_ff_net_2", rest)
    if m:
        return ("blocks", int(m.group(1)), "ff2")
    if rest == "proj_in":
        return ("proj_in",)
    if rest == "proj_out":
        return ("proj_out",)
    m = re.match(r"conv(\d)", rest)
    if m:
        return (f"conv{m.group(1)}",)
    if rest == "conv_shortcut":
        return ("shortcut",)
    if rest == "time_emb_proj":
        return ("time_emb",)
    return None


_KOHYA_TE_RE = re.compile(
    r"lora_te\d?_text_model_encoder_layers_(\d+)_(.*)")


def _kohya_te_path(name: str):
    m = _KOHYA_TE_RE.match(name)
    if not m:
        return None
    layer, rest = int(m.group(1)), m.group(2)
    tails = {
        "self_attn_q_proj": ("attn", "q"), "self_attn_k_proj": ("attn", "k"),
        "self_attn_v_proj": ("attn", "v"),
        "self_attn_out_proj": ("attn", "out"),
        "mlp_fc1": ("fc1",), "mlp_fc2": ("fc2",),
    }
    tail = tails.get(rest)
    return ("blocks", layer) + tail if tail else None


def _diffusers_unet_path(name: str):
    """diffusers/peft key prefix -> unet tree path, or None."""
    name = name.replace(".processor", "")
    parts = name.split(".")
    try:
        i = 1 if parts[0] == "unet" else 0
        sec = parts[i]
        if sec == "mid_block":
            if parts[i + 1] == "attentions":
                out = ["mid", "attn"]
            else:
                out = ["mid", "res1" if parts[i + 2] == "0" else "res2"]
            i += 3
        else:
            out = ["down" if sec == "down_blocks" else "up", int(parts[i + 1])]
            out.append("attns" if parts[i + 2] == "attentions" else "resnets")
            out.append(int(parts[i + 3]))
            i += 4
        tail = _module_tail("_".join(parts[i:]))
        return tuple(out) + tail if tail else None
    except (IndexError, ValueError):
        return None


# ------------------------------------------------------------ delta build


def _f32(v) -> np.ndarray:
    """A state-dict value (numpy, or a torch tensor of any float dtype) as
    a float32 numpy array."""
    if torch.is_tensor(v):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def _rebuild_delta(entry: dict) -> np.ndarray | None:
    """One module's adapter tensors -> dense torch-layout delta, f32.

    LoRA: up @ down * (alpha/rank); LoHa: (w1a@w1b)*(w2a@w2b)*(alpha/dim);
    LoKr: kron(w1, w2)*scale; full: diff."""
    def g(name):
        v = entry.get(name)
        return None if v is None else _f32(v)

    if "diff" in entry:
        return g("diff")

    up, down = g("lora_up"), g("lora_down")
    if up is not None and down is not None:
        rank = down.shape[0]
        alpha = float(entry.get("alpha", rank))
        if down.ndim == 4:  # conv lora
            kh, kw = down.shape[2], down.shape[3]
            up2 = up.reshape(up.shape[0], -1)
            down2 = down.reshape(down.shape[0], -1)
            delta = (up2 @ down2).reshape(up.shape[0], down.shape[1], kh, kw)
        else:
            delta = up @ down
        return delta * (alpha / rank)

    w1a, w1b = g("hada_w1_a"), g("hada_w1_b")
    if w1a is not None:
        w2a, w2b = g("hada_w2_a"), g("hada_w2_b")
        rank = w1b.shape[0]
        alpha = float(entry.get("alpha", rank))
        delta = (w1a @ w1b) * (w2a @ w2b)
        return delta * (alpha / rank)

    lokr_w1, lokr_w2 = g("lokr_w1"), g("lokr_w2")
    if lokr_w1 is not None or "lokr_w1_a" in entry:
        if lokr_w1 is None:
            lokr_w1 = g("lokr_w1_a") @ g("lokr_w1_b")
        if lokr_w2 is None and "lokr_w2_a" in entry:
            lokr_w2 = g("lokr_w2_a") @ g("lokr_w2_b")
        rank = entry.get("_rank", lokr_w1.shape[-1])
        alpha = float(entry.get("alpha", rank))
        delta = np.kron(lokr_w1, lokr_w2)
        return delta * (alpha / rank)
    return None


_SUFFIXES = {
    ".lora_up.weight": "lora_up", ".lora_down.weight": "lora_down",
    ".lora_B.weight": "lora_up", ".lora_A.weight": "lora_down",
    ".lora.up.weight": "lora_up", ".lora.down.weight": "lora_down",
    ".lora_linear_layer.up.weight": "lora_up",
    ".lora_linear_layer.down.weight": "lora_down",
    ".alpha": "alpha", ".hada_w1_a": "hada_w1_a",
    ".hada_w1_b": "hada_w1_b", ".hada_w2_a": "hada_w2_a",
    ".hada_w2_b": "hada_w2_b", ".lokr_w1": "lokr_w1",
    ".lokr_w2": "lokr_w2", ".lokr_w1_a": "lokr_w1_a",
    ".lokr_w1_b": "lokr_w1_b", ".lokr_w2_a": "lokr_w2_a",
    ".lokr_w2_b": "lokr_w2_b", ".diff": "diff",
}


def group_modules(state: dict) -> dict[str, dict]:
    """Group flat checkpoint keys by module name."""
    groups: dict[str, dict] = defaultdict(dict)
    for key, val in state.items():
        for suf, slot in _SUFFIXES.items():
            if key.endswith(suf):
                groups[key[: -len(suf)]][slot] = val
                break
    return dict(groups)


_TE_TAILS = {
    "self_attn.q_proj": ("attn", "q"), "self_attn.k_proj": ("attn", "k"),
    "self_attn.v_proj": ("attn", "v"), "self_attn.out_proj": ("attn", "out"),
    "mlp.fc1": ("fc1",), "mlp.fc2": ("fc2",),
}


def resolve_path(module_name: str):
    """module name (any format) -> ('unet'|'te', tree path) or None."""
    if module_name.startswith("lora_unet_"):
        p = _kohya_unet_path(module_name)
        return ("unet", p) if p else None
    if module_name.startswith("lora_te"):
        p = _kohya_te_path(module_name)
        return ("te", p) if p else None
    if module_name.startswith(("unet.", "down_blocks", "up_blocks",
                               "mid_block")):
        p = _diffusers_unet_path(module_name)
        return ("unet", p) if p else None
    if module_name.startswith(("text_encoder.", "text_model.")):
        m = re.search(r"layers\.(\d+)\.(.+)", module_name)
        if m:
            tail = _TE_TAILS.get(m.group(2))
            if tail:
                return ("te", ("blocks", int(m.group(1))) + tail)
    return None


# ---------------------------------------------------------------- folding


def _tree_get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _tree_set(tree, path, value):
    """Functional set: a new tree whose untouched subtrees are shared."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    out = list(tree) if isinstance(tree, list) else dict(tree)
    out[head] = _tree_set(tree[head], rest, value)
    return out


def port_delta(delta: np.ndarray, kind: str, shape: tuple):
    """A torch-layout delta in the layout of a leaf of ``kind`` and
    ``shape``, or None where it does not fit (skipped, as in the JAX
    package): a conv delta on a linear leaf keeps its first tap, a 2-D
    delta on a conv leaf does not fit."""
    if kind == "conv_hwio" and delta.ndim == 4:
        delta = delta.transpose(2, 3, 1, 0)
    elif kind == "linear" and delta.ndim == 4:
        delta = delta[:, :, 0, 0]
    return delta if tuple(delta.shape) == tuple(shape) else None


def fold_leaf(leaf, delta: np.ndarray):
    """(leaf.float() + delta) rounded to the leaf's dtype, as a new tensor:
    the delta (already scaled, f32) uploaded, the add and the rounding in
    one pass on the leaf's device."""
    d = torch.from_numpy(np.ascontiguousarray(delta, np.float32)).to(
        leaf.device)
    out = torch.empty_like(leaf)
    torch.add(leaf, d, out=out)
    return out


def model_scales(scale) -> dict[str, float]:
    """A scale, or a per-model dict keyed '*' / 'unet' / 'text_encoder'
    (the named entry wins over '*'), as {'unet', 'text_encoder'}."""
    if isinstance(scale, dict):
        wild = scale.get("*", 1.0)
        return {"unet": float(scale.get("unet", wild)),
                "text_encoder": float(scale.get("text_encoder", wild))}
    return {"unet": float(scale), "text_encoder": float(scale)}


def lora_deltas(state: dict, scale: float | dict = 1.0, *, config):
    """The host half of ``apply_lora``, no device work: [(which, path,
    delta)] for every module that resolves to a leaf its delta fits, which
    "unet" or "te" (tower 0), the delta in the leaf's layout and scaled,
    f32. ``config`` is the ModelSet's config (its spec trees give each
    leaf's layout and shape)."""
    from ..models.modelset import model_specs

    unet_specs, _, text_specs = model_specs(config)
    scales = model_scales(scale)
    out = []
    for mod_name, entry in group_modules(state).items():
        resolved = resolve_path(mod_name)
        if resolved is None:
            continue
        which, path = resolved
        delta = _rebuild_delta(entry)
        if delta is None:
            continue
        specs = unet_specs if which == "unet" else text_specs[0]
        try:
            spec = _tree_get(specs, path + ("w",))
        except (KeyError, IndexError, TypeError):
            continue
        delta = port_delta(delta, spec.kind, spec.shape)
        if delta is None:
            continue
        s = scales["unet" if which == "unet" else "text_encoder"]
        out.append((which, path, np.ascontiguousarray(
            delta * np.float32(s), np.float32)))
    return out


def fold_deltas(unet_params, text_params_list, deltas):
    """The device half of ``apply_lora``: (unet_params', text_params_list',
    applied) with each of ``lora_deltas``' deltas folded into its leaf."""
    new_unet = unet_params
    new_te = list(text_params_list)
    for which, path, delta in deltas:
        tree = new_unet if which == "unet" else new_te[0]
        leaf = _tree_get(tree, path + ("w",))
        if isinstance(leaf, L.Shards):
            # a tensor-parallel leaf: the delta split as the leaf was
            from ..parallel import mesh as pmesh

            wpath = path + ("w",)
            new_leaf = L.Shards(fold_leaf(s, d) for s, d in zip(
                leaf, pmesh.split_leaf(wpath, delta, pmesh.leaf_spec(wpath),
                                       len(leaf))))
        else:
            new_leaf = fold_leaf(leaf, delta)
        if which == "unet":
            new_unet = _tree_set(new_unet, path + ("w",), new_leaf)
        else:
            new_te[0] = _tree_set(new_te[0], path + ("w",), new_leaf)
    return new_unet, new_te, len(deltas)


def apply_lora(unet_params, text_params_list, state: dict,
               scale: float | dict = 1.0, *, config):
    """(unet_params', text_params_list', applied) with the adapter's deltas
    folded in; ``config`` is the ModelSet's config (its spec trees give
    each leaf's layout). The text-encoder deltas go to tower 0, as in the
    JAX package: an SDXL LoRA's ``lora_te2_`` (OpenCLIP-bigG) deltas do not
    fit CLIP-L's leaves there and are dropped (ROADMAP queue 3)."""
    return fold_deltas(unet_params, text_params_list,
                       lora_deltas(state, scale, config=config))


# -------------------------------------------------------- textual inversion


def extract_ti_embeddings(state: dict) -> dict[str, np.ndarray]:
    """Token-embedding artifact -> {token: [n_vectors, dim]}.

    Supports the A1111 .pt layout ({'string_to_param': {'*': tensor}}),
    bare {'emb_params': ...}, and {token: tensor} safetensors."""
    out = {}
    if "string_to_param" in state:
        for tok, ten in state["string_to_param"].items():
            out[tok if tok != "*" else "<embedding>"] = _f32(ten)
        return out
    if "emb_params" in state:
        out["<embedding>"] = _f32(state["emb_params"])
        return out
    for key, val in state.items():
        arr = _f32(val)
        if arr.ndim == 1:
            arr = arr[None]
        if arr.ndim == 2:
            out[key] = arr
    return out


class TokenizerWithTI:
    """A tokenizer with added TI tokens mapping to appended embedding
    rows."""

    def __init__(self, base, added: dict[str, list[int]]):
        self.base = base
        self.added = added
        self.bos, self.eos, self.pad = base.bos, base.eos, base.pad

    def encode(self, text: str):
        if not self.added:
            return self.base.encode(text)
        names = sorted(self.added, key=len, reverse=True)
        pattern = "(" + "|".join(re.escape(n) for n in names) + ")"
        out: list[int] = []
        for part in re.split(pattern, text):
            if part in self.added:
                out.extend(self.added[part])
            elif part:
                out.extend(self.base.encode(part))
        return out


def apply_textual_inversions(modelset, embeddings: dict[str, np.ndarray]):
    """(new text_params list, wrapped tokenizer): the embedding rows
    appended to tower 0's token table (a new tensor), each token string
    mapped to its new ids; vectors of another width are skipped."""
    te = modelset.text_params[0]
    table = te["token_embedding"]
    added: dict[str, list[int]] = {}
    rows = []
    next_id = table.shape[0]
    for token, vecs in embeddings.items():
        vecs = _f32(vecs)
        if vecs.ndim == 1:
            vecs = vecs[None]
        if vecs.shape[-1] != table.shape[-1]:
            continue
        added[token] = list(range(next_id, next_id + len(vecs)))
        next_id += len(vecs)
        rows.append(vecs)
    if not rows:
        return modelset.text_params, modelset.tokenizer
    new_rows = torch.from_numpy(np.concatenate(rows)).to(table.device,
                                                          table.dtype)
    new_te = dict(te)
    new_te["token_embedding"] = torch.cat([table, new_rows], dim=0)
    return ([new_te] + list(modelset.text_params[1:]),
            TokenizerWithTI(modelset.tokenizer, added))
