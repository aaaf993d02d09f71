"""The work counts of flops.py: one K1 and one K2b launch against hand
counts, the launches of a UNet call and a decode against the kernels'
known counts, and the UNet's FLOPs against torch's own counter on the
plain reference."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import family, flops, peaks, weights
from benchmark.reference import sd
from benchmark.tests import cells

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _unet_call(cfg, *args):
    """The SD family's count of one UNet call (families/sd.py)."""
    return family.code(cfg).unet_call(cfg["unet"], *args)


def test_k1_hand_count():
    # SD1.5's 64x64 self-attention at batch 8 (16 CFG rows), 8 heads, d 40
    f, b = flops.k1_cost(16, 8, 4096, 4096, 40)
    assert f == 4 * 16 * 8 * 4096 * 4096 * 40
    assert b == 2 * 16 * 8 * 40 * (2 * 4096 + 2 * 4096)
    s, term = flops.least_seconds(f, b)
    assert term == "flops" and s == pytest.approx(f / peaks.BF16_FLOPS)


def test_k2b_hand_count():
    # SD1.5's 64x64 320 -> 320 conv at 16 rows
    m = 16 * 64 * 64
    f, b = flops.k2b_cost(m, 320, 320)
    assert f == 2 * m * 320 * 9 * 320
    assert b == 2 * (m * 320 + 9 * 320 * 320 + m * 320)
    # a memory-bound shape: one row, few channels
    s, term = flops.least_seconds(*flops.k2b_cost(512 * 512, 8, 8))
    assert term == "bytes"


@pytest.mark.parametrize("name,k1,k2b", [("sd15", 32, 44),
                                         ("sdxl", 140, 34)])
def test_launches_per_call(name, k1, k2b):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    h = cfg["unet"]["sample_size"]
    call = _unet_call(cfg, 2, h, h)
    assert (len(call.k1), len(call.k2b)) == (k1, k2b)
    dec = flops.vae_decode(cfg["vae"], 1, h, h)
    assert (len(dec.k1), len(dec.k2b)) == (1, 28)
    assert dec.k1 == [(1, 1, h * h, h * h, 512)]


def test_unet_flops_match_torch_counter():
    cfg = cells.test_config()
    state = weights.make(cfg, 5, "cpu", torch.float32)
    net = sd.Net(weights.part(state, "unet"))
    u = cfg["unet"]
    x = torch.randn(2, 4, 8, 8)
    ctx = torch.randn(2, 77, u["cross_attention_dim"])
    with FlopCounterMode(display=False) as counter:
        sd.unet_forward(net, u, x, torch.tensor([10.0, 10.0]), ctx)
    assert counter.get_total_flops() == _unet_call(cfg, 2, 8, 8).flops


def test_decode_and_tower_flops_match_torch_counter():
    cfg = cells.test_config()
    state = weights.make(cfg, 5, "cpu", torch.float32)
    with FlopCounterMode(display=False) as counter:
        sd.vae_decode(sd.Net(weights.part(state, "vae")), cfg["vae"],
                      torch.randn(1, 4, 8, 8))
    assert counter.get_total_flops() == flops.vae_decode(cfg["vae"], 1, 8,
                                                         8).flops
    ids = torch.tensor([sd.token_ids("a red fox")] * 2)
    with FlopCounterMode(display=False) as counter:
        sd.clip_forward(sd.Net(weights.part(state, "text_encoder")),
                        cfg["text_encoder"], ids, -1)
    assert counter.get_total_flops() == flops.text_tower(
        cfg["text_encoder"], 2).flops


def test_request_is_its_parts():
    """A txt2img request under parallel CFG: the towers on prompt and
    negative prompt, 2 UNet rows a step, one decode (34.67 TFLOP an SD1.5
    image at 512², 281.1 an SDXL one at 1024²)."""
    cfg = json.loads((CONFIGS / "sd15.json").read_text())
    work = flops.request(cfg, 1, 512, 512, 20)
    parts = (flops.text_tower(cfg["text_encoder"], 2).flops +
             20 * _unet_call(cfg, 2, 64, 64).flops +
             flops.vae_decode(cfg["vae"], 1, 64, 64).flops)
    assert work.flops == parts
    assert round(work.flops / 1e12, 2) == 34.67
    assert len(work.k1) == 20 * 32 + 1 and len(work.k2b) == 20 * 44 + 28
    xl = json.loads((CONFIGS / "sdxl.json").read_text())
    assert round(flops.request(xl, 1, 1024, 1024, 20).flops / 1e12, 1) == \
        281.1


@pytest.mark.parametrize("name,params", [("sd15", 1_066_235_307),
                                         ("sdxl", 3_468_837_867)])
def test_published_parameter_counts(name, params):
    """UNet 859.5 M / 2567.5 M, VAE 83.7 M, CLIP-L 123.1 M, bigG 694.7 M."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    assert weights.count(cfg) == params


def test_chunk_work_follows_the_chunk():
    """A batch's chunks as the dispatcher logs them add up to its
    requests' work at the size they ran; pad rows are run, not useful."""
    from benchmark.program import Chunk

    cfg = json.loads((CONFIGS / "sd15.json").read_text())

    def chunks(rows, pad, h, w):
        return [Chunk("steps", rows, pad, 0, 10, h, w, 0.0, 0.0, True),
                Chunk("steps", rows, pad, 10, 20, h, w, 0.0, 0.0, True),
                Chunk("decode", rows, pad, 20, 20, h, w, 0.0, 0.0, True)]

    for h, w in ((512, 512), (768, 512)):
        ran, useful = flops.Work(), 0.0
        for c in chunks(4, 1, h, w):
            work, f = flops.chunk_work(cfg, c)
            ran.add(work)
            useful += f
        assert useful == flops.request(cfg, 3, h, w, 20).flops
        assert ran.flops == flops.request(cfg, 4, h, w, 20).flops - \
            flops.text_tower(cfg["text_encoder"], 8).flops
        assert ran.k2b == flops.request(cfg, 4, h, w, 20).k2b
    assert flops.chunk_work(cfg, chunks(1, 0, 768, 512)[0])[1] > \
        flops.chunk_work(cfg, chunks(1, 0, 512, 512)[0])[1]
