"""A configuration's model family, found by name as files (family.py):
the SD family's numbers are those it had before they moved into
``families/sd.py``; a new family joins as new files alone; a
configuration that names no family stops the run."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import family, flops, harness, weights
from benchmark.program import Chunk
from benchmark.tests import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _digest(value) -> str:
    return hashlib.sha256(repr(value).encode()).hexdigest()[:16]


# Read from the benchmark before the SD family moved into families/sd.py:
# each cell's configuration at its batch (8 images of 512², 4 of 1024²),
# 20 steps; per chunk (two of 10 steps, one padding row in the first, then
# the decode) the FLOPs run, the useful FLOPs, and the K1 and K2b launch
# lists' digests.
PINNED = {
    "sd15": {
        "rows": 8, "size": 512, "count": 1066235307,
        "layout": "a48b79239786cf60",
        "request": [277376428736512.0, "39677be6750cd85d",
                    "ed748cd121f72189"],
        "chunks": [
            [128523750604800.0, 112644460830720.0, "32a06d888f5ddd96",
             "c3cebb0cf0476f25"],
            [128523750604800.0, 128523750604800.0, "32a06d888f5ddd96",
             "c3cebb0cf0476f25"],
            [20116151468032.0, 17601632534528.0, "06fa7cab42fcce59",
             "46490588a059b9d1"]]},
    "sdxl": {
        "rows": 4, "size": 1024, "count": 3468837867,
        "layout": "991713ab721b9e80",
        "request": [1124568686952448.0, "5d3bd57dd188e051",
                    "f5a212209428e730"],
        "chunks": [
            [540898911846400.0, 406341153546240.0, "d3ded5899a658559",
             "9f6a27461a62c34f"],
            [540898911846400.0, 540898911846400.0, "d3ded5899a658559",
             "9f6a27461a62c34f"],
            [41881570377728.0, 31411177783296.0, "2f1bf045aae2225d",
             "15902d5158c37296"]]},
}
# every drawn tensor of the test preset (float32, cells.SEED), by key
PINNED_TEST_WEIGHTS = "4b9c7e094407ee08"


@pytest.mark.parametrize("name", sorted(PINNED))
def test_sd_numbers_unchanged_by_the_move(name):
    want = PINNED[name]
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    rows, size = want["rows"], want["size"]
    assert weights.count(cfg) == want["count"]
    assert _digest([(k, tuple(s), kind) for k, s, kind in
                    weights.layout(cfg)]) == want["layout"]
    req = flops.request(cfg, rows, size, size, 20)
    assert [req.flops, _digest(req.k1), _digest(req.k2b)] == want["request"]
    got = []
    for c in (Chunk("steps", rows, 1, 0, 10, size, size, 0, 0, True),
              Chunk("steps", rows, 0, 10, 20, size, size, 0, 0, True),
              Chunk("decode", rows, 1, 20, 20, size, size, 0, 0, True)):
        work, useful = flops.chunk_work(cfg, c)
        got.append([work.flops, useful, _digest(work.k1),
                    _digest(work.k2b)])
    assert got == want["chunks"]


def test_test_preset_weights_unchanged_by_the_move():
    state = weights.make(cells.test_config(), cells.SEED, "cpu",
                         torch.float32)
    h = hashlib.sha256()
    for key in sorted(state):
        h.update(key.encode())
        h.update(state[key].contiguous().numpy().tobytes())
    assert h.hexdigest()[:16] == PINNED_TEST_WEIGHTS


def test_vae_without_post_quant_conv():
    """A published ``use_post_quant_conv: false`` (FLUX.1's VAE) drops the
    1x1 conv from the layout, the decode's work and the reference; the SD
    files leave the key out, and keep it."""
    from benchmark.reference import sd

    v = dict(cells.test_config()["vae"])
    keys = {k for k, _, _ in weights.vae_layout(v)}
    assert "post_quant_conv.weight" in keys
    with_conv = flops.vae_decode(v, 1, 8, 8).flops
    v["use_post_quant_conv"] = False
    assert "post_quant_conv.weight" not in {
        k for k, _, _ in weights.vae_layout(v)}
    lc = v["latent_channels"]
    assert flops.vae_decode(v, 1, 8, 8).flops == \
        with_conv - 2.0 * 64 * lc * lc
    state = {k: torch.zeros(s) for k, s, _ in weights.vae_layout(v)}
    out = sd.vae_decode(sd.Net(state), v, torch.zeros(1, lc, 8, 8))
    assert out.shape[:2] == (1, v["out_channels"])


# ------------------------------------------------ a family added as files

SPY = '''

SENTINEL = "sdcopy"
CALLS = []


def _spy(fn):
    def spied(*args, **kwargs):
        CALLS.append(fn.__name__)
        return fn(*args, **kwargs)
    return spied


layout, request, chunk_work, serve = (
    _spy(f) for f in (layout, request, chunk_work, serve))
'''

REFERENCE_SPY = '''

SENTINEL = "sdcopy"
CALLS = []
_generate = Reference.generate


def _spied_generate(self, requests, device):
    CALLS.append("generate")
    return _generate(self, requests, device)


Reference.generate = _spied_generate
'''


def _copy(tmp_path) -> Path:
    data = tmp_path / "benchmark"
    shutil.copytree(BENCH, data, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    return data


def test_new_family_needs_new_files_only(tmp_path):
    """A family ``sdcopy`` added as families/sdcopy.py, reference/sdcopy.py
    and configs/sdcopy.json (with a cell of its own) is reached by the
    run's every step: the weights' layout, the served model set, the
    reference of the check, the work of a request and of a chunk; no file
    that is there changes."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    data = _copy(tmp_path)
    before = {p: p.read_bytes() for p in data.rglob("*") if p.is_file()}
    (data / "families" / "sdcopy.py").write_text(
        (data / "families" / "sd.py").read_text() + SPY)
    (data / "reference" / "sdcopy.py").write_text(
        (data / "reference" / "sd.py").read_text() + REFERENCE_SPY)
    cfg = cells.test_config()
    cfg.update(name="sdcopy", family="sdcopy")
    (data / "configs" / "sdcopy.json").write_text(json.dumps(cfg))
    tiny = cells.test_cell(steps=4)
    mix = {k: v for k, v in tiny["mix"].items() if k != "words_path"}
    (data / "traffic" / "tiny.json").write_text(json.dumps(mix))
    wl = dict(tiny["workload"], config="sdcopy", traffic="tiny")
    (data / "workloads" / "sdcopy.tiny.json").write_text(json.dumps(wl))
    grown = json.loads(json.dumps(manifest))
    grown["workloads"].append({"name": "sdcopy.tiny", "config": "sdcopy",
                               "traffic": "tiny", "chips": 1,
                               "why": "a family added as files"})

    cell = harness.cell_files(grown, "sdcopy.tiny", data=data)
    code, ref = family.code(cell["config"]), family.reference(cell["config"])
    assert (code.SENTINEL, ref.SENTINEL) == ("sdcopy", "sdcopy")
    assert family.code(cells.test_config()) is not code
    run = harness.measure(cell, cells.SEED, 2.0, False, 0.0, device="cpu")
    out = harness.check(run, device="cpu")
    assert run.check["correct"], out
    assert {"layout", "serve"} <= set(code.CALLS)
    assert ref.CALLS and set(ref.CALLS) == {"generate"}
    assert flops.request(cell["config"], 1, 64, 64, 4).flops > 0
    assert flops.chunk_work(cell["config"], run.chunks[0])[0].flops > 0
    assert {"request", "chunk_work"} <= set(code.CALLS)
    assert {p: p.read_bytes() for p in before} == before


def test_config_without_family_is_refused(tmp_path):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    data = _copy(tmp_path)
    path = data / "configs" / "sd15.json"
    cfg = json.loads(path.read_text())
    del cfg["family"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(harness.RunError, match="configs/sd15.json"):
        harness.cell_files(manifest, "sd15-512.c16", data=data)
