"""ImageAdjustment chains: the protocol's 18 image operations applied to a
[B,H,W,C] tensor in [0,1].

Counterpart of gyre_tpu/services/adjustments.py. The pure image ops run
through ops/images.py. The model-backed ones borrow the manager's task
engine for their task (``task_pipeline``; an ImageAdjustment's own
``engine_id`` picks one): a configured depth (MiDaS DPT, ZoeDepth), edge
(HED, DexiNed, line art), segmentation (UniFormer), pose (OpenPose),
normal (BAE) or background-removal (InSPyReNet: its RGBA's alpha is the
subject mask) engine runs (models/). Only where no engine of the task is
configured does an op
take the JAX package's tensor fallback: sobel edges, the luminance depth
proxy, a palletised blur, normals from luminance, the saliency threshold.
So a chain never answers with an image that the JAX package, configured
alike, would not give. A configured engine that fails to build or to run
fails the chain.
"""

from __future__ import annotations

import logging

import torch

from ..generated import generation_pb2 as pb
from ..ops import images as I

logger = logging.getLogger(__name__)

_RESCALE_FIT = {
    pb.RESCALE_STRICT: "strict",
    pb.RESCALE_COVER: "cover",
    pb.RESCALE_CONTAIN_ZERO: "contain",
    pb.RESCALE_CONTAIN_REPLICATE: "contain",
    pb.RESCALE_CONTAIN_REFLECT: "contain",
}

_CHANNEL_NAMES = {pb.CHANNEL_R: "r", pb.CHANNEL_G: "g", pb.CHANNEL_B: "b",
                  pb.CHANNEL_A: "a", pb.CHANNEL_ZERO: "zero",
                  pb.CHANNEL_ONE: "one"}


def apply_image_adjustment(image, adjustments, manager=None,
                           engine_id: str | None = None, seed: int = 0):
    """image [B,H,W,C] in [0,1] (a tensor, or numpy for the CPU) -> the
    adjusted image, f32 on the image's device. Each adjustment may name its
    own task engine (``ImageAdjustment.engine_id``), else ``engine_id``.
    ``seed`` seeds the shuffle's flow. One chain shares a ``ctx``: the
    background mask that ``background_removal.reapply`` uses again."""
    img = image if torch.is_tensor(image) else torch.as_tensor(image)
    img = img.float()
    ctx: dict = {}
    for adj in adjustments:
        which = adj.WhichOneof("adjustment")
        if which is None:
            continue
        img = _APPLIERS[which](img, getattr(adj, which), manager,
                               adj.engine_id or engine_id, seed, ctx)
    return img


def _blur(img, a, *_):
    direction = {pb.DIRECTION_UP: "up", pb.DIRECTION_DOWN: "down"}.get(
        a.direction)
    if direction:
        return I.directionalblur(img, a.sigma or 1.0, direction)
    return I.gaussian_blur(img, a.sigma or 1.0)


def _invert(img, a, *_):
    return I.invert(img)


def _levels(img, a, *_):
    return I.levels(img, a.input_low, a.input_high or 1.0, a.output_low,
                    a.output_high or 1.0)


def _channels(img, a, *_):
    """The output's channels from sources, a DISCARDed one left out; a
    source channel the image lacks reads as ones."""
    b, h, w, c = img.shape
    outs = []
    for src in (a.r, a.g, a.b, a.a):
        if src == pb.CHANNEL_DISCARD:
            continue
        name = _CHANNEL_NAMES.get(src, "zero")
        idx = I.CHANNEL_INDEX.get(name)
        if name == "zero":
            outs.append(torch.zeros((b, h, w, 1), device=img.device))
        elif name == "one" or idx >= c:
            outs.append(torch.ones((b, h, w, 1), device=img.device))
        else:
            outs.append(img[..., idx:idx + 1])
    return torch.cat(outs, dim=-1)


def _rescale(img, a, *_):
    return I.rescale(img, a.height, a.width,
                     fit=_RESCALE_FIT.get(a.mode, "strict"))


def _autoscale(img, a, *_):
    return I.autoscale(img, a.height or img.shape[1],
                       a.width or img.shape[2])


def _crop(img, a, *_):
    return I.crop(img, a.top, a.left, a.height or img.shape[1] - a.top,
                  a.width or img.shape[2] - a.left)


def _canny(img, a, *_):
    return I.canny_edge(img, a.low_threshold or 0.1,
                        a.high_threshold or 0.2).repeat(1, 1, 1, 3)


def _edge(img, a, manager, engine_id, seed, ctx=None):
    model = _task_engine(manager, "edge", engine_id)
    if model is not None:
        return model(img)
    mag, _ = I.sobel_edges(I.gaussian_blur(img, 1.0))
    return (mag * 2.0).clamp(0, 1).repeat(1, 1, 1, 3)


def _depth(img, a, manager, engine_id, seed, ctx=None):
    model = _task_engine(manager, "depth", engine_id)
    if model is not None:
        return model(img)
    logger.warning("no depth engine configured; using luminance proxy")
    g = I.gaussian_blur(I.to_grayscale(img), 2.0)
    return I.normalise(g).repeat(1, 1, 1, 3)


def _segmentation(img, a, manager, engine_id, seed, ctx=None):
    model = _task_engine(manager, "segmentation", engine_id)
    if model is not None:
        return model(img)
    return I.palletize(I.gaussian_blur(img, 4.0), 8)


def _openpose(img, a, manager, engine_id, seed, ctx=None):
    return _pose(img, manager, engine_id, style="openpose")


def _keypose(img, a, manager, engine_id, seed, ctx=None):
    return _pose(img, manager, engine_id, style="keypose")


def _pose(img, manager, engine_id, style: str):
    model = _task_engine(manager, "pose", engine_id)
    if model is not None:
        return model(img, style=style)
    raise NotImplementedError(
        "pose estimation requires a configured pose engine")


def _normal(img, a, manager=None, engine_id=None, seed=0, ctx=None):
    model = _task_engine(manager, "normal", engine_id)
    if model is not None:
        n = model(img)
        return I.gaussian_blur(n, a.postblur) if a.postblur else n
    depth = I.to_grayscale(img)
    if a.preblur:
        depth = I.gaussian_blur(depth, a.preblur)
    n = I.normalmap_from_depthmap(depth, a.background_threshold or 0.05)
    return I.gaussian_blur(n, a.postblur) if a.postblur else n


def _background_removal(img, a, manager, engine_id, seed, ctx=None):
    """Compute (or, with ``reapply``, take the chain's memorised) subject
    mask, then ALPHA (the mask as alpha), SOLID (black background), BLUR
    (the background infilled and blurred behind the subject) or NOTHING
    (memorise only)."""
    ctx = {} if ctx is None else ctx
    if a.reapply:
        mask = ctx.get("bgmask")
        if mask is None:
            raise ValueError("No mask memorised to reapply")
    else:
        model = _task_engine(manager, "background_removal", engine_id)
        if model is not None:
            mask = model(img)[..., 3:4]
        else:
            g = I.gaussian_blur(I.to_grayscale(img), 4.0)
            edge = (g - g.mean(dim=(1, 2, 3), keepdim=True)).abs()
            mask = (I.normalise(edge) > 0.25).float()
        ctx["bgmask"] = mask
    mode = a.mode if a.HasField("mode") else pb.ALPHA
    if mode == pb.NOTHING:
        return img
    rgb = img[..., :3]
    if mode == pb.ALPHA:
        return torch.cat([rgb, mask], dim=-1)
    if mode == pb.SOLID:
        return rgb * mask
    if mode == pb.BLUR:
        bg = I.gaussian_blur(I.infill(rgb, 1.0 - mask, 26), 13.0)
        return rgb * mask + bg * (1.0 - mask)
    raise ValueError(f"Unknown background removal mode {mode}")


def _palletize(img, a, *_):
    return I.palletize(img, a.colours or 16)


def _quantize(img, a, *_):
    return I.quantize(img, a.threshold or 0.5)


def _shuffle(img, a, manager, engine_id, seed, ctx=None):
    return I.shuffle(img, I.shuffle_flow(img.shape, seed))


def _task_engine(manager, task: str, engine_id):
    """The manager's task pipeline for ``task`` (None without a manager,
    or when none of the task is configured)."""
    if manager is None:
        return None
    return manager.task_pipeline(task, engine_id)


_APPLIERS = {
    "blur": _blur, "invert": _invert, "levels": _levels,
    "channels": _channels, "rescale": _rescale, "autoscale": _autoscale,
    "crop": _crop, "canny_edge": _canny, "edge_detection": _edge,
    "depth": _depth, "segmentation": _segmentation, "keypose": _keypose,
    "openpose": _openpose, "normal": _normal,
    "background_removal": _background_removal, "palletize": _palletize,
    "quantize": _quantize, "shuffle": _shuffle,
}
