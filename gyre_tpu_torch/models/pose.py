"""Pose estimation and OpenPose-style skeleton rendering.

Counterpart of gyre_tpu/models/pose.py:

  * ``PoseNet``: the small CPM-shaped net a pose engine without a
    checkpoint random-inits (a stride-8 conv stem, residual blocks with
    GroupNorm, 18 keypoint maps and 2 part-affinity channels a limb);
  * ``BodyPose``: the published OpenPose body CPM (``body_pose_model.pth``:
    a VGG stem and 6 two-branch refinement stages, 38 PAF and 19 heat
    channels), its PAF channels permuted into ``LIMBS`` order;
  * the decoders: the per-keypoint argmax, 3x3-NMS peaks (a stable sort,
    so ties go to the lower index as in ``lax.top_k``), the PAF line
    integral and mutual-best limb matching, the openpose and keypose
    distance-field renders;
  * ``make_topdown``: the default two-pass path. The bottom-up pass's
    accepted limbs are union-found into people on the host
    (``group_people``, numpy), each person's box is cropped bilinearly and
    run through the same network again, and each crop's argmax joints are
    rendered; with nobody found the bottom-up render stands.

Parameter names follow the JAX package's params trees (``stages.2.paf.0.
weight`` is its ``stages[2]["paf"][0]["w"]``). The trunks run in the
model's dtype (bf16 on the card); the last conv of each output (the maps
peak-picking and limb scoring read) and every decoder in f32. Grids are
built with ``jnp.linspace``'s arithmetic (layers.linspace), a division by
a constant is a product with its reciprocal (as XLA compiles it) and the
PAF integral sums its samples in a fixed order, so the decoders give the
JAX package's bits, and a decode on the card gives the CPU's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (conv1x1_f32, conv_nchw, linspace, load_state, nchw,
                     nhwc, random_init)

N_KEYPOINTS = 18

# COCO-18 limb pairs and the canonical OpenPose limb colors
LIMBS = [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
         (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
         (0, 15), (15, 17)]
LIMB_COLORS = np.asarray([
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
    (170, 255, 0), (85, 255, 0), (0, 255, 0), (0, 255, 85),
    (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255),
    (0, 0, 255), (85, 0, 255), (170, 0, 255), (255, 0, 255),
    (255, 0, 170)], np.float32) / 255.0

# keypose (the T2I adapter's hint): COCO-17 joints from the openpose-18
# order, a fixed blue/green/orange palette, joints drawn over thin links
KEYPOSE_FROM_OPENPOSE = np.asarray(
    [0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10], np.int64)
KEYPOSE_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6)]
_KP_BLUE, _KP_GREEN, _KP_ORANGE = ((51, 153, 255), (0, 255, 0),
                                   (255, 128, 0))
KEYPOSE_KPT_COLORS = np.asarray(
    [_KP_BLUE] * 5 + [_KP_GREEN, _KP_ORANGE] * 6, np.float32) / 255.0
KEYPOSE_LINK_COLORS = np.asarray(
    [_KP_GREEN, _KP_GREEN, _KP_ORANGE, _KP_ORANGE] + [_KP_BLUE] * 4
    + [_KP_GREEN, _KP_ORANGE, _KP_GREEN, _KP_ORANGE] + [_KP_BLUE] * 7,
    np.float32) / 255.0


def _colors(table, device):
    return torch.from_numpy(table).to(device)


def _over(x, n: int):
    """x / n as XLA compiles a division by a constant: x times the f32
    reciprocal of n."""
    return x * float(np.float32(1.0) / np.float32(n))


# ---------------------------------------------------------------- PoseNet


class _PoseBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.conv2 = nn.Conv2d(c, c, 3), nn.Conv2d(c, c, 3)
        self.norm = nn.GroupNorm(8, c)


class PoseNet(nn.Module):
    """The small heatmap + PAF net; ``forward`` is
    ``heatmaps_and_pafs``."""

    def __init__(self, width: int = 64, n_blocks: int = 6):
        super().__init__()
        self.stem1 = nn.Conv2d(3, width, 3)
        self.stem2 = nn.Conv2d(width, width, 3)
        self.stem3 = nn.Conv2d(width, width * 2, 3)
        self.blocks = nn.ModuleList(_PoseBlock(width * 2)
                                    for _ in range(n_blocks))
        self.head1 = nn.Conv2d(width * 2, width, 1)
        self.head2 = nn.Conv2d(width, N_KEYPOINTS, 1)
        self.paf1 = nn.Conv2d(width * 2, width, 1)
        self.paf2 = nn.Conv2d(width, 2 * len(LIMBS), 1)

    body = False                # its maps are logits: decoders take sigmoid

    @property
    def dtype(self):
        return self.stem1.weight.dtype

    def to_compute(self, dtype, device):
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        for m in (self.head2, self.paf2):
            m.float()
        return self

    def forward(self, images):
        """images [B,H,W,3] in [0,1] -> (keypoint maps [B,H/8,W/8,18], PAFs
        [B,H/8,W/8,34]), f32."""
        x = nchw((images.float() * 2.0 - 1.0).to(self.dtype))
        for conv in (self.stem1, self.stem2, self.stem3):
            x = F.relu(conv_nchw(conv, x, stride=2, padding=1))
        for blk in self.blocks:
            h = conv_nchw(blk.conv2, F.relu(conv_nchw(blk.conv1, x)))
            n = blk.norm
            x = F.relu(F.group_norm((x + h).float(), n.num_groups,
                                    n.weight.float(), n.bias.float(),
                                    n.eps).to(x.dtype))
        maps = conv1x1_f32(self.head2, F.relu(nhwc(conv_nchw(
            self.head1, x))))
        pafs = conv1x1_f32(self.paf2, F.relu(nhwc(conv_nchw(self.paf1, x))))
        return maps, pafs


def random_posenet(seed: int = 0, dtype=torch.float32,
                   device="cuda") -> PoseNet:
    with torch.device(device):
        model = PoseNet()
    return random_init(model, seed).to_compute(dtype, torch.device(device))


# ------------------------------------------ OpenPose body model (CMU CPM)

# stem: (name, c_in, c_out) 3x3 convs, "pool" a 2x2/2 max-pool
BODY_STEM = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool",
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), "pool",
    ("conv3_1", 128, 256), ("conv3_2", 256, 256),
    ("conv3_3", 256, 256), ("conv3_4", 256, 256), "pool",
    ("conv4_1", 256, 512), ("conv4_2", 512, 512),
    ("conv4_3_CPM", 512, 256), ("conv4_4_CPM", 256, 128),
]
N_PAF = 2 * len(LIMBS) + 4      # 38 channels (19 limb pairs with the ears)
N_HEAT = N_KEYPOINTS + 1        # + background
# the PAF channel pair of each LIMBS entry in the checkpoint's order
LIMB_PAF = [(12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25),
            (0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29),
            (30, 31), (34, 35), (32, 33), (36, 37)]


def _stage_spec(stage: int, out_ch: int):
    """(published name, c_in, c_out, kernel) of one refinement branch."""
    b = "L1" if out_ch == N_PAF else "L2"
    if stage == 1:
        return [(f"conv5_1_CPM_{b}", 128, 128, 3),
                (f"conv5_2_CPM_{b}", 128, 128, 3),
                (f"conv5_3_CPM_{b}", 128, 128, 3),
                (f"conv5_4_CPM_{b}", 128, 512, 1),
                (f"conv5_5_CPM_{b}", 512, out_ch, 1)]
    names = [(f"Mconv1_stage{stage}_{b}", 128 + N_PAF + N_HEAT, 128, 7)]
    names += [(f"Mconv{i}_stage{stage}_{b}", 128, 128, 7)
              for i in range(2, 6)]
    names += [(f"Mconv6_stage{stage}_{b}", 128, 128, 1),
              (f"Mconv7_stage{stage}_{b}", 128, out_ch, 1)]
    return names


class BodyPose(nn.Module):
    """The OpenPose body CPM; ``forward`` is ``body_apply``."""

    body = True                 # its maps are in [0, 1] already

    def __init__(self):
        super().__init__()
        self.stem = nn.ModuleList(nn.Conv2d(ci, co, 3)
                                  for e in BODY_STEM if e != "pool"
                                  for (_, ci, co) in [e])
        self.stages = nn.ModuleList(
            nn.ModuleDict({tag: nn.ModuleList(
                nn.Conv2d(ci, co, k) for (_, ci, co, k) in
                _stage_spec(s, out_ch))
                for tag, out_ch in (("paf", N_PAF), ("heat", N_HEAT))})
            for s in range(1, 7))

    @property
    def dtype(self):
        return self.stem[0].weight.dtype

    def to_compute(self, dtype, device):
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        for branch in self.stages[-1].values():
            branch[-1].float()
        return self

    @staticmethod
    def _branch(convs, x, last: bool):
        for conv in convs[:-1]:
            x = F.relu(conv_nchw(conv, x))
        if last:                          # the maps the decoders read: f32
            return conv1x1_f32(convs[-1], nhwc(x))
        return conv_nchw(convs[-1], x)

    def forward(self, images):
        """images [B,H,W,3] RGB in [0,1] -> (heat [B,H/8,W/8,18], PAFs
        [B,H/8,W/8,34] in LIMBS order), f32. The published input: BGR
        shifted by -0.5."""
        x = nchw((images.float().flip(-1) - 0.5).to(self.dtype))
        it = iter(self.stem)
        for e in BODY_STEM:
            x = F.max_pool2d(x, 2) if e == "pool" else \
                F.relu(conv_nchw(next(it), x))
        feat = x
        n = len(self.stages)
        paf = self._branch(self.stages[0]["paf"], feat, n == 1)
        heat = self._branch(self.stages[0]["heat"], feat, n == 1)
        for s, branch in enumerate(self.stages[1:], start=2):
            inp = torch.cat([paf, heat, feat], dim=1)
            paf = self._branch(branch["paf"], inp, s == n)
            heat = self._branch(branch["heat"], inp, s == n)
        perm = torch.as_tensor(np.asarray(LIMB_PAF).reshape(-1),
                               device=paf.device)
        return heat[..., :N_KEYPOINTS], paf[..., perm]


def random_body(seed: int = 0, dtype=torch.float32,
                device="cuda") -> BodyPose:
    with torch.device(device):
        model = BodyPose()
    return random_init(model, seed).to_compute(dtype, torch.device(device))


def _body_keys(model: BodyPose):
    """(conv, published key prefix) of every body-model conv."""
    names = [e[0] for e in BODY_STEM if e != "pool"]
    for conv, name in zip(model.stem, names):
        yield conv, f"model0.{name}"
    for s, stage in enumerate(model.stages, start=1):
        for bi, (tag, out_ch) in enumerate((("paf", N_PAF),
                                            ("heat", N_HEAT)), start=1):
            for conv, (name, *_) in zip(stage[tag], _stage_spec(s, out_ch)):
                yield conv, f"model{s}_{bi}.{name}"


def load_body(state: dict, dtype=torch.float32, device="cuda") -> BodyPose:
    """The published ``body_pose_model.pth`` (``model0.conv1_1`` stem,
    ``model{s}_{1,2}`` branches; a DataParallel "module." prefix
    dropped) -> the model."""
    if not any(k.startswith("model0.") for k in state):
        state = {k.split("module.", 1)[-1]: v for k, v in state.items()}
    with torch.device(device):
        model = BodyPose()
    names = {id(m): n for n, m in model.named_modules()}
    values = {}
    for conv, key in _body_keys(model):
        pre = names[id(conv)]
        values[f"{pre}.weight"] = state[f"{key}.weight"]
        values[f"{pre}.bias"] = state.get(
            f"{key}.bias", np.zeros(conv.weight.shape[0], np.float32))
    return load_state(model, lambda p: values[p], "body pose").to_compute(
        dtype, torch.device(device))


def state_dict_body(model: BodyPose) -> dict:
    """The model in the published layout (f32 numpy)."""
    return {f"{key}.{k}": getattr(conv, k).detach().float().cpu().numpy()
            for conv, key in _body_keys(model) for k in ("weight", "bias")}


# --------------------------------------------------------------- decoders


def decode_keypoints(maps, apply_sigmoid: bool = True):
    """[B,h,w,K] -> (xy [B,K,2] in 0..1, confidence [B,K]): each map's
    argmax (the first of equal maxima)."""
    b, h, w, k = maps.shape
    flat = maps.reshape(b, h * w, k)
    conf, idx = flat.amax(dim=1), flat.argmax(dim=1)
    if apply_sigmoid:
        conf = torch.sigmoid(conf)
    ys = _over((idx // w).float(), max(h - 1, 1))
    xs = _over((idx % w).float(), max(w - 1, 1))
    return torch.stack([xs, ys], dim=-1), conf


def _grid(height: int, width: int, device):
    return (linspace(1.0, height, device)[:, None],
            linspace(1.0, width, device)[None, :])


def _segment_dist2(xx, yy, pa, pb):
    """Squared distance of each pixel (xx [..,1,W], yy [..,H,1]) to the
    segments pa -> pb ([..., 2], broadcast in front of the grid)."""
    dx = (pb[..., 0] - pa[..., 0])[..., None, None]
    dy = (pb[..., 1] - pa[..., 1])[..., None, None]
    len2 = torch.clamp(dx ** 2 + dy ** 2, min=1e-8)
    px = xx - pa[..., 0][..., None, None]
    py = yy - pa[..., 1][..., None, None]
    t = torch.clamp((px * dx + py * dy) / len2, 0.0, 1.0)
    return (px - t * dx) ** 2 + (py - t * dy) ** 2


def render_openpose(keypoints, conf, height: int, width: int,
                    threshold: float = 0.3, limb_width: float = 0.02):
    """keypoints [B,K,2] (0..1), conf [B,K] -> canvas [B,H,W,3]: each limb
    whose two joints pass ``threshold``, in its color."""
    dev = keypoints.device
    yy, xx = _grid(height, width, dev)
    colors = _colors(LIMB_COLORS, dev)
    canvas = torch.zeros((keypoints.shape[0], height, width, 3), device=dev)
    for li, (a, bk) in enumerate(LIMBS):
        ok = ((conf[:, a] > threshold) & (conf[:, bk] > threshold)).float()
        dist = torch.sqrt(_segment_dist2(xx, yy, keypoints[:, a],
                                         keypoints[:, bk]))
        mask = (dist < limb_width).float() * ok[:, None, None]
        canvas = torch.maximum(canvas, mask[..., None] * colors[li])
    return canvas


def render_keypose(keypoints, conf, height: int, width: int,
                   threshold: float = 0.4, radius_px: float = 4.0,
                   thickness_px: float = 2.0):
    """The T2I adapter's keypose render: keypoints [B,K,2] (0..1,
    openpose-18 order), conf [B,K] -> canvas [B,H,W,3]: thin COCO-17 links,
    then joint dots over them."""
    dev = keypoints.device
    order = torch.from_numpy(KEYPOSE_FROM_OPENPOSE).to(dev)
    kp, cf = keypoints[:, order], conf[:, order]
    yy, xx = _grid(height, width, dev)
    scale = float(max(height, width))
    r = radius_px / scale
    lw = 0.5 * thickness_px / scale
    canvas = torch.zeros((kp.shape[0], height, width, 3), device=dev)
    link_c = _colors(KEYPOSE_LINK_COLORS, dev)
    for li, (a, bk) in enumerate(KEYPOSE_SKELETON):
        ok = ((cf[:, a] > threshold) & (cf[:, bk] > threshold)).float()
        dist2 = _segment_dist2(xx, yy, kp[:, a], kp[:, bk])
        mask = (dist2 < lw * lw).float() * ok[:, None, None]
        canvas = torch.maximum(canvas, mask[..., None] * link_c[li])
    kpt_c = _colors(KEYPOSE_KPT_COLORS, dev)
    for j in range(kp.shape[1]):
        ok = (cf[:, j] > threshold).float()
        d2 = (xx - kp[:, j, 0][:, None, None]) ** 2 + \
            (yy - kp[:, j, 1][:, None, None]) ** 2
        mask = (d2 < r * r).float() * ok[:, None, None]
        canvas = torch.where(mask[..., None] > 0, kpt_c[j], canvas)
    return canvas


def render_pose(keypoints, conf, height: int, width: int,
                style: str = "openpose", threshold: float | None = None):
    """openpose (thick 17-color limbs) or keypose (dots and thin lines)."""
    kw = {} if threshold is None else {"threshold": threshold}
    if style == "keypose":
        return render_keypose(keypoints, conf, height, width, **kw)
    return render_openpose(keypoints, conf, height, width, **kw)


def top_peaks(maps, max_people: int = 8, nms_window: int = 3,
              apply_sigmoid: bool = True):
    """Per-keypoint peaks: 3x3 max-pool NMS, then the ``max_people``
    largest by a stable descending sort (equal values in index order, as
    ``lax.top_k`` takes them). maps [B,h,w,K] -> (xy [B,K,P,2] in 0..1,
    conf [B,K,P]); without ``apply_sigmoid`` (the body model's [0,1]
    maps) a slot with no peak has confidence 0."""
    b, h, w, k = maps.shape
    m = nchw(maps)
    pooled = F.max_pool2d(m, nms_window, 1, nms_window // 2)
    peaks = torch.where(m >= pooled, m, torch.full_like(m, -torch.inf))
    flat = peaks.reshape(b, k, h * w)
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :max_people], idx[..., :max_people]
    ys = _over((idx // w).float(), max(h - 1, 1))
    xs = _over((idx % w).float(), max(w - 1, 1))
    conf = torch.sigmoid(vals) if apply_sigmoid else \
        torch.where(torch.isfinite(vals), vals, torch.zeros_like(vals))
    return torch.stack([xs, ys], dim=-1), conf


def _paf_scores(paf_x, paf_y, pa, pb, samples: int = 10):
    """The OpenPose limb score of every pair: the mean dot product of the
    PAF with the unit vector pa -> pb at ``samples`` points along it.
    paf_x/paf_y [h,w], pa [P,2], pb [P,2] -> [P,P] (rows pa, columns
    pb); the samples summed in order."""
    h, w = paf_x.shape
    t = linspace(1.0, samples, paf_x.device)
    a, b = pa[:, None, :], pb[None, :, :]
    xs = a[..., 0:1] + (b[..., 0:1] - a[..., 0:1]) * t
    ys = a[..., 1:2] + (b[..., 1:2] - a[..., 1:2]) * t
    xi = torch.clamp((xs * (w - 1)).to(torch.int32), 0, w - 1).long()
    yi = torch.clamp((ys * (h - 1)).to(torch.int32), 0, h - 1).long()
    vx, vy = paf_x[yi, xi], paf_y[yi, xi]
    d = b - a
    norm = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + 1e-8)
    u0, u1 = (d[..., 0] / norm)[..., None], (d[..., 1] / norm)[..., None]
    dots = vx * u0 + vy * u1
    acc = dots[..., 0]
    for s in range(1, samples):
        acc = acc + dots[..., s]
    return _over(acc, samples)


def _match_limbs_full(xy, conf, pafs, conf_threshold, paf_threshold):
    p = xy.shape[1]
    ar = torch.arange(p, device=xy.device)
    pa_out, pb_out, ok_out, bj_out = [], [], [], []
    for li, (a, b) in enumerate(LIMBS):
        score = _paf_scores(pafs[..., 2 * li], pafs[..., 2 * li + 1],
                            xy[a], xy[b])
        valid = (conf[a][:, None] > conf_threshold) & \
            (conf[b][None, :] > conf_threshold)
        score = torch.where(valid, score, torch.full_like(score, -torch.inf))
        best_j = score.argmax(dim=1)
        best_i = score.argmax(dim=0)
        mutual = best_i[best_j] == ar
        s_best = score[ar, best_j]
        pa_out.append(xy[a])
        pb_out.append(xy[b][best_j])
        ok_out.append((mutual & (s_best > paf_threshold)).float())
        bj_out.append(best_j.to(torch.int32))
    return (torch.stack(pa_out), torch.stack(pb_out), torch.stack(ok_out),
            torch.stack(bj_out))


def match_limbs(xy, conf, pafs, conf_threshold: float = 0.3,
                paf_threshold: float = 0.05):
    """Mutual-best PAF matching of one image: xy [K,P,2], conf [K,P], pafs
    [h,w,2L] -> (pa [L,P,2], pb [L,P,2], ok [L,P]). A pair survives iff
    each end is the other's best-scoring partner, both joints pass
    ``conf_threshold`` and the line integral passes ``paf_threshold``."""
    pa, pb, ok, _ = _match_limbs_full(xy, conf, pafs, conf_threshold,
                                      paf_threshold)
    return pa, pb, ok


def match_limb_indices(xy, conf, pafs, conf_threshold: float = 0.3,
                       paf_threshold: float = 0.05):
    """As match_limbs, but (best_j [L,P] int32, ok [L,P]): peak i of a
    limb's first joint matches peak best_j[i] of its second."""
    _, _, ok, best_j = _match_limbs_full(xy, conf, pafs, conf_threshold,
                                         paf_threshold)
    return best_j, ok


def render_limbs(pa, pb, ok, height: int, width: int,
                 limb_width: float = 0.02):
    """Matched segments pa/pb [L,P,2], ok [L,P] -> [H,W,3] canvas."""
    dev = pa.device
    yy, xx = _grid(height, width, dev)
    colors = _colors(LIMB_COLORS, dev)
    canvas = torch.zeros((height, width, 3), device=dev)
    for li in range(pa.shape[0]):
        dist = torch.sqrt(_segment_dist2(xx, yy, pa[li], pb[li]))
        masks = (dist < limb_width).float() * ok[li][:, None, None]
        canvas = torch.maximum(canvas, masks.amax(dim=0)[..., None] *
                               colors[li])
    return canvas


def render_multi(maps, pafs, height: int, width: int, body: bool,
                 max_people: int = 8, style: str = "openpose"):
    """The bottom-up decode and render of the maps of a batch: every
    PAF-validated limb (the body model with the published thresholds 0.1
    and 0.05), or for keypose the single-person argmax."""
    if style == "keypose":
        kps, conf = decode_keypoints(maps, apply_sigmoid=not body)
        return render_pose(kps, conf, height, width, style=style,
                           **({"threshold": 0.1} if body else {}))
    xy, conf = top_peaks(maps, max_people, apply_sigmoid=not body)
    thr = {"conf_threshold": 0.1, "paf_threshold": 0.05} if body else {}
    return torch.stack([
        render_limbs(*match_limbs(xy[i], conf[i], pafs[i], **thr), height,
                     width) for i in range(maps.shape[0])])


def estimate_and_render(model, images, max_people: int = 8,
                        style: str = "openpose"):
    """Bottom-up: image [B,H,W,3] -> skeleton canvas [B,H,W,3]
    (``estimate_and_render_body`` for the body model,
    ``estimate_and_render_multi`` for PoseNet)."""
    maps, pafs = model(images)
    return render_multi(maps, pafs, images.shape[1], images.shape[2],
                        model.body, max_people, style)


# -------------------------------------------------- top-down refinement


def group_people(xy, conf, best_j, ok, min_joints: int = 3,
                 margin: float = 0.25, max_people: int = 8):
    """Union-find the accepted limbs into people -> crop boxes, on the host
    (numpy). xy [K,P,2] 0..1, conf [K,P], best_j/ok [L,P] -> (boxes [M,4]
    (x0,y0,x1,y1) in 0..1, valid [M] bool), M = max_people, largest
    cluster first; a person needs ``min_joints`` distinct joints."""
    xy = np.asarray(xy)
    best_j = np.asarray(best_j)
    ok = np.asarray(ok)
    p = xy.shape[1]
    parent: dict = {}

    def find(n):
        while parent.setdefault(n, n) != n:
            parent[n] = parent[parent[n]]
            n = parent[n]
        return n

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for li, (a, b) in enumerate(LIMBS):
        for i in range(p):
            if ok[li, i] > 0:
                union((a, i), (b, int(best_j[li, i])))
    clusters: dict = {}
    for node in list(parent):
        clusters.setdefault(find(node), []).append(node)
    boxes, valid = [], []
    for members in sorted(clusters.values(), key=len, reverse=True):
        if len({k for (k, _) in members}) < min_joints:
            continue
        pts = np.stack([xy[k, i] for (k, i) in members])
        x0, y0 = pts.min(axis=0)
        x1, y1 = pts.max(axis=0)
        # a margin of the larger side, at least 0.1 of the image, so a
        # head-only cluster still crops some context
        side = max(x1 - x0, y1 - y0, 0.1)
        mx = my = margin * side
        boxes.append([max(x0 - mx, 0.0), max(y0 - my, 0.0),
                      min(x1 + mx, 1.0), min(y1 + my, 1.0)])
        valid.append(True)
        if len(boxes) >= max_people:
            break
    while len(boxes) < max_people:
        boxes.append([0.0, 0.0, 1.0, 1.0])
        valid.append(False)
    return np.asarray(boxes, np.float32), np.asarray(valid, np.bool_)


def bilinear_crop(image, boxes, crop: int):
    """[crop,crop,3] patches of ``image`` [H,W,3] over the 0..1 boxes
    [M,4] (x0,y0,x1,y1), bilinear -> [M,crop,crop,3]."""
    h, w = image.shape[0], image.shape[1]
    s = linspace(1.0, crop, image.device)
    ys = (boxes[:, 1:2] + (boxes[:, 3:4] - boxes[:, 1:2]) * s) * (h - 1)
    xs = (boxes[:, 0:1] + (boxes[:, 2:3] - boxes[:, 0:1]) * s) * (w - 1)
    yi = torch.clamp(torch.floor(ys).to(torch.int32), 0, h - 2).long()
    xi = torch.clamp(torch.floor(xs).to(torch.int32), 0, w - 2).long()
    fy = (ys - yi)[:, :, None, None]
    fx = (xs - xi)[:, None, :, None]
    r0, r1 = yi[:, :, None], yi[:, :, None] + 1
    c0, c1 = xi[:, None, :], xi[:, None, :] + 1
    return (image[r0, c0] * (1 - fy) * (1 - fx) +
            image[r0, c1] * (1 - fy) * fx +
            image[r1, c0] * fy * (1 - fx) + image[r1, c1] * fy * fx)


def refine_people(model, image, boxes, valid, crop: int = 368,
                  threshold: float = 0.1, style: str = "openpose"):
    """The second pass over one image [H,W,3]: each box cropped and run
    through ``model``, each crop's argmax joints mapped back and rendered,
    the renders max-combined -> [H,W,3]."""
    heat, _ = model(bilinear_crop(image, boxes, crop))
    kps, conf = decode_keypoints(heat, apply_sigmoid=not model.body)
    origin = boxes[:, None, 0:2]
    kps = origin + kps * (boxes[:, None, 2:4] - origin)
    conf = conf * valid[:, None].float()
    return torch.stack([
        render_pose(kps[i:i + 1], conf[i:i + 1], image.shape[0],
                    image.shape[1], style=style, threshold=threshold)[0]
        for i in range(kps.shape[0])]).amax(dim=0)


def make_topdown(model, max_people: int = 8, crop: int = 368,
                 threshold: float = 0.1):
    """The two-pass pose hinter: a callable (images [B,H,W,3] in [0,1],
    style="openpose" | "keypose") -> canvas [B,H,W,3] f32. The bottom-up
    pass finds people, ``group_people`` boxes them on the host, and each
    image's boxes are refined; an image with nobody keeps its bottom-up
    render."""

    def run(images, style: str = "openpose"):
        images = images.float()
        maps, pafs = model(images)
        xy, conf = top_peaks(maps, max_people, apply_sigmoid=not model.body)
        fallback = render_multi(maps, pafs, images.shape[1],
                                images.shape[2], model.body, max_people,
                                style)
        outs = []
        for b in range(images.shape[0]):
            bj, ok = match_limb_indices(xy[b], conf[b], pafs[b],
                                        conf_threshold=threshold,
                                        paf_threshold=0.05)
            boxes, valid = group_people(xy[b].cpu().numpy(),
                                        conf[b].cpu().numpy(),
                                        bj.cpu().numpy(), ok.cpu().numpy(),
                                        max_people=max_people)
            if not valid.any():
                outs.append(fallback[b])
                continue
            outs.append(refine_people(
                model, images[b], torch.from_numpy(boxes).to(images.device),
                torch.from_numpy(valid).to(images.device), crop, threshold,
                style))
        return torch.stack(outs)

    return run
