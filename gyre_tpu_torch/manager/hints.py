"""HintsetManager: hint type -> conditioning model (a ControlNet or a T2I
adapter) for an engine.

Counterpart of gyre_tpu/manager/hints.py. Hintset entries use the
reference format

    - hintset_id: "hintset-sd15-controlnet11"
      controlnet11/canny:
        aliases: ["controlnet/canny", "canny"]
        priority: 210
        model: "@controlnet11-canny"

where "@model-id" references a model_id entry whose weights the
EngineManager resolves; the compact ``hints: {type: model}`` form parses
too. A hint model whose weights do not load is logged and made with random
weights (the JAX package's semantics for a model), from a seed that is a
stable function of its hint type, so every process makes the same one.
Random weights follow the JAX package's init: a ControlNet's zero convs
are zero (it adds exactly zero), a T2I adapter's weights are all random.
"""

from __future__ import annotations

import logging
import zlib
from dataclasses import dataclass

import torch

logger = logging.getLogger(__name__)

# canonical hint types the protocol knows (reference hintsets.yaml)
HINT_ALIASES = {
    "canny": "canny_edge", "canny_edge": "canny_edge", "edge": "canny_edge",
    "hed": "soft_edge", "softedge": "soft_edge", "soft_edge": "soft_edge",
    "depth": "depth", "depth_map": "depth",
    "normal": "normal", "normal_map": "normal",
    "pose": "pose", "openpose": "pose", "keypose": "pose",
    "segmentation": "segmentation", "seg": "segmentation",
    "scribble": "scribble", "mlsd": "mlsd", "shuffle": "shuffle",
    "tile": "tile", "inpaint": "inpaint", "lineart": "lineart",
    "sketch": "scribble", "color": "color", "style": "style",
}

_T2I_FAMILIES = ("t2i", "coadapter")


def _canon(t: str) -> str:
    return HINT_ALIASES.get(t, t)


def random_seed(hint_type: str) -> int:
    """The seed of a hint type's random weights: the same in every
    process (Python's str hash is salted per process)."""
    return zlib.crc32(hint_type.encode()) & 0x7FFFFFFF


@dataclass
class HintModelSpec:
    hint_type: str                   # canonical primary type
    aliases: tuple = ()              # extra accepted types (canonicalized)
    kind: str = "controlnet"         # controlnet | t2i
    model: str | None = None         # "@model-id" ref, path, or None
    priority: int = 0
    hintset: str = ""                # owning hintset_id ("" = global)
    name: str = ""                   # entry key, e.g. "controlnet11/canny"

    def matches(self, htype: str) -> bool:
        return htype == self.hint_type or htype in self.aliases


def parse_hintset_entry(entry: dict) -> list[HintModelSpec]:
    """One hintset config dict -> specs (both formats)."""
    out: list[HintModelSpec] = []
    set_id = str(entry.get("hintset_id", ""))
    # compact format
    for htype, cfg in (entry.get("hints") or {}).items():
        if isinstance(cfg, str):
            cfg = {"model": cfg}
        out.append(HintModelSpec(
            hint_type=_canon(htype), hintset=set_id, name=htype,
            kind=(cfg or {}).get("kind", "controlnet"),
            model=(cfg or {}).get("model"),
            priority=int((cfg or {}).get("priority", 0))))
    # reference format: "<family>/<type>" keys
    for key, cfg in entry.items():
        if key in ("hintset_id", "hints") or not isinstance(cfg, dict):
            continue
        if "/" not in key:
            continue
        family, _, tname = key.partition("/")
        aliases = cfg.get("aliases") or []
        if isinstance(aliases, str):
            aliases = [aliases]
        kind = cfg.get("kind") or (
            "t2i" if family.startswith(_T2I_FAMILIES) else "controlnet")
        out.append(HintModelSpec(
            hint_type=_canon(tname), hintset=set_id, name=key,
            aliases=tuple(_canon(a) for a in aliases),
            kind=kind, model=cfg.get("model"),
            priority=int(cfg.get("priority", 0))))
    return out


class HintsetManager:
    def __init__(self, specs: list[dict] | None, unet_cfg,
                 compute_dtype=torch.bfloat16, device="cuda",
                 model_loader=None):
        """model_loader: callable("@ref" | path) -> (state_dict, ...)
        raising on failure, supplied by the EngineManager so that
        "@model-id" references resolve through its model registry."""
        self.unet_cfg = unet_cfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.model_loader = model_loader
        self.specs: list[HintModelSpec] = []
        for entry in specs or []:
            if isinstance(entry, dict):
                self.specs.extend(parse_hintset_entry(entry))
        self._cache: dict = {}

    def set_ids(self) -> list[str]:
        return sorted({s.hintset for s in self.specs if s.hintset})

    def types_for(self, hintset: str | None = None) -> list[str]:
        """Hint types a hintset (all of them when unset) offers."""
        out = set()
        for s in self.specs:
            if not hintset or s.hintset == hintset:
                out.add(s.hint_type)
                out.update(s.aliases)
        return sorted(out)

    def for_type(self, hint_type: str, unet_cfg=None,
                 hintset: str | None = None):
        """-> {"params", "kind"}, or None when no hintset names the type.
        The specs of the engine's hintset (all sets when it has none
        there) that match the type compete on priority. unet_cfg is the
        serving engine's (a hint model is bound to the UNet's
        architecture)."""
        cfg = unet_cfg or self.unet_cfg
        htype = _canon(hint_type)
        pool = [s for s in self.specs
                if not hintset or s.hintset == hintset]
        candidates = [s for s in pool if s.matches(htype)]
        if not candidates and hintset:  # fall back across all sets
            candidates = [s for s in self.specs if s.matches(htype)]
        if not candidates:
            return None
        spec = max(candidates, key=lambda s: s.priority)
        key = (htype, spec.kind, spec.model, cfg)
        if key not in self._cache:
            self._cache[key] = self._build(spec, cfg)
        return self._cache[key]

    def _load_state(self, spec: HintModelSpec):
        if self.model_loader is not None:
            return self.model_loader(spec.model)[0]
        from ..models.load import read_state_dict

        return read_state_dict(spec.model)

    def _build(self, spec: HintModelSpec, cfg):
        state = None
        if spec.model:
            try:
                state = self._load_state(spec)
            except Exception as e:  # noqa: BLE001 - logged, random weights
                logger.warning("hint %s: weights %s unavailable (%s); "
                               "random-init", spec.hint_type, spec.model, e)
        kw = dict(dtype=self.compute_dtype, device=self.device)
        seed = random_seed(spec.hint_type)
        if spec.kind == "t2i":
            from ..models import t2i_adapter

            if state is not None:
                params = t2i_adapter.load_params(state, **kw)
            else:
                chans = tuple(cfg.block_out_channels)
                chans += (chans[-1],) * (4 - len(chans))
                params = t2i_adapter.random_t2i_adapter(chans[:4], seed,
                                                        **kw)
            return {"params": params, "kind": "t2i"}
        from ..models import controlnet

        if state is not None:
            from ..models.load import load_controlnet_params

            params = load_controlnet_params(state, cfg, **kw)
        else:
            if spec.model is None:
                logger.info("hint %s: random-init controlnet (no weights "
                            "configured)", spec.hint_type)
            params = controlnet.random_controlnet(cfg, seed, **kw)
        return {"params": params, "kind": "controlnet"}
