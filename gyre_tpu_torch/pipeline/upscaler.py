"""UpscalerPipeline: tiled super-resolution with the alpha channel passed
through.

Counterpart of gyre_tpu/pipeline/upscaler.py, on the same tile grid: the
image reflect-padded by the overlap and up to the grid, tiles of ``tile``
pixels every ``tile - 2 * overlap`` (the last row and column clamped to
the padded edge), each tile's output weighted by a linear feather over
its overlap, the weighted sum divided by the summed weights and cropped
back. The alpha channel is resized on its own (ops/images.py ``rescale``,
strict, lanczos3). The tiles and their weights accumulate on the model's
device, a batch of tiles a model call, and the result stays there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import esrgan
from ..ops import images as I


def reflect_index(n: int, before: int, after: int) -> np.ndarray:
    """Indices of ``np.pad(range(n), (before, after), mode="reflect")``,
    any pad width (numpy reflects again past the far edge)."""
    i = np.arange(-before, n + after)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    j = np.mod(i, period)
    return np.where(j >= n, period - j, j)


class UpscalerPipeline:
    batch_tiles = 8         # tiles a model call

    def __init__(self, model, scale: int = 4, tile: int = 128,
                 overlap: int = 16):
        self.model = model
        self.scale = scale
        self.tile = tile
        self.overlap = overlap
        self.device = next(model.parameters()).device

    def _feather(self, th: int, tw: int) -> torch.Tensor:
        ov = self.overlap * self.scale
        wy = np.ones(th, np.float32)
        wx = np.ones(tw, np.float32)
        if ov:
            ramp = np.linspace(0, 1, ov + 2)[1:-1]
            wy[:ov], wy[-ov:] = ramp, ramp[::-1]
            wx[:ov], wx[-ov:] = ramp, ramp[::-1]
        return torch.from_numpy(wy[:, None, None] * wx[None, :, None]).to(
            self.device)

    def positions(self, h: int, w: int) -> tuple[list, int, int]:
        """The tiles' (y, x) on the padded canvas, and its (H, W)."""
        t, ov = self.tile, self.overlap
        step = t - 2 * ov
        ph = max(0, -(-max(h - 2 * ov, 1) // step) * step + 2 * ov - h)
        pw = max(0, -(-max(w - 2 * ov, 1) // step) * step + 2 * ov - w)
        H, W = h + ph + 2 * ov, w + pw + 2 * ov
        return [(min(y, H - t), min(x, W - t))
                for y in range(0, H - 2 * ov, step)
                for x in range(0, W - 2 * ov, step)], H, W

    @torch.inference_mode()
    def __call__(self, image) -> torch.Tensor:
        """image [B,H,W,3|4] in [0,1] (array or tensor) -> [B,sH,sW,C] f32
        on the model's device."""
        img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                              else image).to(self.device, torch.float32)
        b, h, w, c = img.shape
        s, t, ov = self.scale, self.tile, self.overlap
        pos, H, W = self.positions(h, w)
        ih = torch.from_numpy(reflect_index(h, ov, H - h - ov)).to(
            self.device)
        iw = torch.from_numpy(reflect_index(w, ov, W - w - ov)).to(
            self.device)
        padded = img[..., :3][:, ih][:, :, iw]
        out = torch.zeros((b, H * s, W * s, 3), device=self.device)
        weight = torch.zeros((1, H * s, W * s, 1), device=self.device)
        feather = self._feather(t * s, t * s)[None]
        for i in range(0, len(pos), self.batch_tiles):
            chunk = pos[i:i + self.batch_tiles]
            res = self.model(torch.cat(
                [padded[:, y:y + t, x:x + t] for y, x in chunk]), s
            ).float()
            for k, (y, x) in enumerate(chunk):
                ys, xs = slice(y * s, (y + t) * s), slice(x * s,
                                                        (x + t) * s)
                out[:, ys, xs] += res[k * b:(k + 1) * b] * feather
                weight[:, ys, xs] += feather
        out = out / weight.clamp_min(1e-6)
        out = out[:, ov * s:(ov + h) * s, ov * s:(ov + w) * s]
        if c == 4:
            out = torch.cat([out, I.rescale(img[..., 3:], h * s, w * s,
                                            fit="strict")], dim=-1)
        return out.clamp(0.0, 1.0)


def build_esrgan_pipeline(state_dict: dict | None = None,
                          num_blocks: int = 23, tile: int = 128,
                          dtype=torch.float32, device="cuda"
                          ) -> UpscalerPipeline:
    """Real-ESRGAN x4 behind the tiled pipeline: from ``state_dict``, else
    random (seed 0) at ``num_blocks``; overlap min(16, tile / 4)."""
    model = esrgan.load_esrgan(state_dict, dtype, device) \
        if state_dict is not None else esrgan.random_esrgan(
            num_blocks, 0, dtype, device)
    return UpscalerPipeline(model, scale=4, tile=tile,
                            overlap=min(16, tile // 4))
