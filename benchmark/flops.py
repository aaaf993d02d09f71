"""Work of a txt2img request, counted from the configuration alone: the
floating-point operations of every matmul and conv (2 per multiply-add),
and the launches of the port's two main kernels with their shapes.

A request's and a chunk's work are the configuration's family's
(``request`` and ``chunk_work`` of ``families/<family>.py``); the parts
any family may share are here: ``vae_decode`` and ``text_tower`` walk the
published config dicts the way the architecture is defined (diffusers'
AutoencoderKL, transformers' CLIPTextModel), as the SD family's
``unet_call`` walks its UNet2DConditionModel. Each returns a ``Work``:
FLOPs, K1 launches as (B, H, Tq, Tk, d) and K2b launches as (M, C, Co), M
being the rows of the implicit GEMM (batch x height x width). The least
time of a launch is the larger of its FLOPs over the card's peak and its
bytes over the card's bandwidth (``peaks.py``); every input byte is
counted read once and every output byte written once, at the true head
size (no padding).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import family, peaks


@dataclass
class Work:
    flops: float = 0.0
    k1: list = field(default_factory=list)     # (B, H, Tq, Tk, d)
    k2b: list = field(default_factory=list)    # (M, C, Co)

    def add(self, other: "Work", times: int = 1) -> "Work":
        self.flops += other.flops * times
        self.k1 += other.k1 * times
        self.k2b += other.k2b * times
        return self


def _conv(m, c, co, k=3):
    return 2.0 * m * co * c * k * k


def _lin(rows, d_in, d_out):
    return 2.0 * rows * d_in * d_out


def _attn(b, h, tq, tk, d):
    return 4.0 * b * h * tq * tk * d


def _resnet(w: Work, b, hw, c, co, temb):
    """Two GN -> SiLU -> conv3x3 (K2a + K2b each), the time projection and
    the 1x1 shortcut."""
    m = b * hw
    w.flops += _conv(m, c, co) + _conv(m, co, co)
    w.k2b += [(m, c, co), (m, co, co)]
    if temb:
        w.flops += _lin(b, temb, co)
    if c != co:
        w.flops += _conv(m, c, co, k=1)


def vae_decode(v: dict, rows: int, h: int, w_: int) -> Work:
    """The VAE decoder on ``rows`` rows of h x w latents; its mid-block
    attention is one single-head K1 launch."""
    chs = list(v["block_out_channels"])
    lc = v["latent_channels"]
    layers = v.get("layers_per_block", 2)
    w = Work()
    hw = h * w_
    if v.get("use_post_quant_conv", True):
        w.flops += _conv(rows * hw, lc, lc, k=1)
    w.flops += _conv(rows * hw, lc, chs[-1])
    c = chs[-1]
    _resnet(w, rows, hw, c, c, None)
    w.flops += 4 * _lin(rows * hw, c, c) + _attn(rows, 1, hw, hw, c)
    w.k1.append((rows, 1, hw, hw, c))
    _resnet(w, rows, hw, c, c, None)
    c_prev = c
    for i, c in enumerate(chs[::-1]):
        for j in range(layers + 1):
            _resnet(w, rows, hw, c_prev if j == 0 else c, c, None)
        c_prev = c
        if i < len(chs) - 1:
            hw *= 4
            w.flops += _conv(rows * hw, c, c)
    w.flops += _conv(rows * hw, chs[0], v["out_channels"])
    return w


def text_tower(t: dict, rows: int, length: int = 77) -> Work:
    """One CLIP text tower on ``rows`` prompts of ``length`` tokens (its
    causal attention runs on the plain path: no K1)."""
    d, f = t["hidden_size"], t["intermediate_size"]
    tok = rows * length
    per_layer = 4 * _lin(tok, d, d) + _attn(rows, t["num_attention_heads"],
                                            length, length,
                                            d // t["num_attention_heads"])
    per_layer += _lin(tok, d, f) + _lin(tok, f, d)
    w = Work(flops=per_layer * t["num_hidden_layers"])
    if "CLIPTextModelWithProjection" in t.get("architectures", []):
        w.flops += _lin(rows, d, t["projection_dim"])
    return w


def request(config: dict, images: int, height: int, width: int,
            steps: int) -> Work:
    """The model work of a batch of ``images`` txt2img requests of one
    size and steps: the ``request`` of the configuration's family."""
    return family.code(config).request(config, images, height, width, steps)


# ------------------------------------------------------------ least times


def k1_cost(b, h, tq, tk, d) -> tuple[float, float]:
    """(FLOPs, bytes) of one K1 launch: QK^T and PV; bf16 q and o
    [B,H,Tq,d], k and v [B,H,Tk,d]."""
    return _attn(b, h, tq, tk, d), 2.0 * b * h * d * (2 * tq + 2 * tk)


def k2b_cost(m, c, co) -> tuple[float, float]:
    """(FLOPs, bytes) of one K2b launch: the implicit GEMM M x Co x 9C;
    bf16 x [M,C], weight [9C,Co] and out [M,Co]."""
    return _conv(m, c, co), 2.0 * (m * c + 9 * c * co + m * co)


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, "flops" or "bytes": the term that binds)."""
    tf, tb = flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
    return max(tf, tb), ("flops" if tf >= tb else "bytes")


# ------------------------------------------------- what a run's chunks did


def chunk_work(config: dict, chunk) -> tuple[Work, float]:
    """(the kernels' work at the rows and size the chunk ran, padding
    included; the model FLOPs of its real rows) of one ``program.Chunk``:
    the ``chunk_work`` of the configuration's family."""
    return family.code(config).chunk_work(config, chunk)


def traced(run) -> tuple[Work, float]:
    """The kernels' work and the model FLOPs of every chunk that ran while
    the trace was on."""
    ran, useful = Work(), 0.0
    for chunk in run.chunks:
        if chunk.traced:
            w, f = chunk_work(run.config, chunk)
            ran.add(w)
            useful += f
    return ran, useful


def roofline(run, launches: list, counter: str, kernel: str, cost):
    """Σ least time / Σ device time (%) of one kernel's launches in the
    traced window, or None without a trace. The launches implied by the
    chunks must equal the program's launch counter. CUPTI may drop a few
    activity records of a long trace (2 of 7,264 seen): the trace must hold
    at least 99.9 % of the launches, and its device time is scaled up by
    the share it lost."""
    t = run.trace
    if t is None:
        return None
    times = [s for name, s in t.kernels if kernel in name]
    counted = t.launches.get(counter, 0)
    if len(launches) != counted or not (
            0.999 * counted <= len(times) <= counted):
        raise RuntimeError(
            f"{counter}: the traced chunks imply {len(launches)} launches, "
            f"the counter says {counted}, the trace holds {len(times)}")
    if not times:
        return None
    least, by = 0.0, {"flops": 0.0, "bytes": 0.0}
    for shape in launches:
        s, term = least_seconds(*cost(*shape))
        least += s
        by[term] += s
    run.notes[f"{counter}_least_s_by_term"] = by
    run.notes[f"{counter}_trace_records_lost"] = counted - len(times)
    return 100.0 * least / (sum(times) * counted / len(times))
