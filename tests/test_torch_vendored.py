"""The port's copies of the JAX package's JAX-free modules against their
originals: the model configs, the fallback tokenizer, the coalescing
dispatcher, the exception -> gRPC status map, the protocol stubs, the
service registration, the engines.yaml DSL and the weight resolver. The port imports none of gyre_tpu, so these copies
must not drift; each test runs the same input through both and compares
exactly (no arithmetic is involved, so there is no tolerance).
"""

import dataclasses
import os
import threading

import grpc
import numpy as np
import pytest

from gyre_tpu.generated import generation_pb2 as jpb
from gyre_tpu.manager import engines_yaml as jyaml
from gyre_tpu.manager import scheduler as jsched
from gyre_tpu.manager import weights as jweights
from gyre_tpu.models import configs as jconfigs
from gyre_tpu.pipeline import tokenizer as jtok
from gyre_tpu.services import exception_to_grpc as jexc
from gyre_tpu.services import registration as jreg
from gyre_tpu_torch.generated import engines_pb2 as tepb
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.manager import engines_yaml as tyaml
from gyre_tpu_torch.manager import scheduler as tsched
from gyre_tpu_torch.manager import weights as tweights
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.pipeline import tokenizer as ttok
from gyre_tpu_torch.services import exception_to_grpc as texc
from gyre_tpu_torch.services import registration as treg


def test_preset_names_match():
    assert list(tconfigs.PRESETS) == list(jconfigs.PRESETS)


@pytest.mark.parametrize("name", sorted(jconfigs.PRESETS))
def test_preset_matches(name):
    port, ref = tconfigs.PRESETS[name], jconfigs.PRESETS[name]
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "A Boat, at SUNSET!!  (oil painting:1.2)",
    "  café  naïve résumé &amp; &lt;tags&gt; ",
    "",
    "1girl, masterpiece, 8k, ultra-detailed, 3.14159",
    "line one\nline two\ttabbed",
]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_fallback_tokenizer_ids_match(prompt):
    port, ref = ttok.FallbackTokenizer(), jtok.FallbackTokenizer()
    assert port.encode(prompt) == ref.encode(prompt)
    assert (port.bos, port.eos, port.pad) == (ref.bos, ref.eos, ref.pad)


# ------------------------------------------------------------- dispatcher
# a subset of tests/test_scheduler.py, run against both dispatchers; each
# scenario returns what it observed, which must be the same for both


class _FakePipe:
    """Records the batch it was called with; returns row-indexed output."""

    def __init__(self):
        self.calls = []

    def __call__(self, **kw):
        seeds = kw.get("seeds") or [0]
        self.calls.append(dict(kw))
        return np.asarray(seeds, np.float32).reshape(-1, 1)


def _merge(mod):
    """3 concurrent requests merge into one batch padded to max_batch."""
    pipe = _FakePipe()
    d = mod.CoalescingDispatcher(max_batch=8, gather_ms=150.0)
    futs = [d.submit(pipe, dict(prompt=f"p{i}", seeds=[10 + i],
                                guidance_scale=5.0)) for i in range(3)]
    outs = [f.result(timeout=30).tolist() for f in futs]
    d.stop()
    return {"calls": [(c["seeds"], c["prompt"]) for c in pipe.calls],
            "outs": outs, "padded": d.padded_rows,
            "dispatched": d.dispatched}


def _solo(mod):
    """Solo jobs never coalesce; a single request stays exact batch-1."""
    pipe = _FakePipe()
    d = mod.CoalescingDispatcher(max_batch=8, gather_ms=150.0)
    futs = [d.submit(pipe, dict(prompt="p", seeds=[i], guidance_scale=5.0),
                     solo=True) for i in range(3)]
    futs.append(d.submit(pipe, dict(prompt="a", seeds=[3],
                                    guidance_scale=7.5)))
    outs = [f.result(timeout=30).tolist() for f in futs]
    d.stop()
    return {"calls": [c["seeds"] for c in pipe.calls], "outs": outs,
            "padded": d.padded_rows}


def _stop(mod):
    """A request whose stop event is set before dispatch is cancelled and
    never reaches the pipeline; the rest of its batch runs. A merged
    batch's combined event is set only when every client stopped."""
    pipe = _FakePipe()
    d = mod.CoalescingDispatcher(max_batch=8, gather_ms=150.0)
    stopped, live = threading.Event(), threading.Event()
    stopped.set()
    f_stop = d.submit(pipe, dict(prompt="x", seeds=[1], guidance_scale=5.0,
                                 stop_event=stopped), stop_event=stopped)
    f_live = d.submit(pipe, dict(prompt="y", seeds=[2], guidance_scale=5.0,
                                 stop_event=live), stop_event=live)
    out = f_live.result(timeout=30).tolist()
    d.stop()
    a, b = threading.Event(), threading.Event()
    combined = mod.CombinedEvent([a, b])
    a.set()
    partial = combined.is_set()
    b.set()
    return {"cancelled": f_stop.cancelled(), "out": out,
            "calls": [c["seeds"] for c in pipe.calls],
            "combined": (partial, combined.is_set(),
                         mod.CombinedEvent([a, None]).is_set())}


@pytest.mark.parametrize("scenario", [_merge, _solo, _stop],
                         ids=["merge", "solo", "stop"])
def test_dispatcher_matches(scenario):
    port, ref = scenario(tsched), scenario(jsched)
    assert port == ref
    if scenario is _merge:       # and both do what test_scheduler expects
        assert port["calls"][0][0] == [10, 11, 12] + [12] * 5
        assert port["outs"] == [[[10.0]], [[11.0]], [[12.0]]]
    if scenario is _stop:
        assert port["cancelled"] and port["calls"] == [[2]]
        assert port["combined"] == (False, True, False)


# ------------------------------------------------------ exception -> gRPC


class _Aborted(Exception):
    pass


class _Context:
    def abort(self, code, detail):
        self.code, self.detail = code, detail
        raise _Aborted


def _status(mod, exc):
    class Servicer:
        @mod.exception_to_grpc()
        def unary(self, request, context):
            raise exc

        @mod.exception_to_grpc()
        def stream(self, request, context):
            yield 1
            raise exc

    codes = []
    for call in (lambda s, c: s.unary(None, c),
                 lambda s, c: list(s.stream(None, c))):
        ctx = _Context()
        with pytest.raises(_Aborted):
            call(Servicer(), ctx)
        codes.append((ctx.code, ctx.detail))
    return codes


@pytest.mark.parametrize("make,code", [
    (lambda sched: sched.DeviceWedgedError("watchdog tripped"),
     grpc.StatusCode.UNAVAILABLE),
    (lambda sched: ValueError("bad size"), grpc.StatusCode.INVALID_ARGUMENT),
    (lambda sched: NotImplementedError("mode"),
     grpc.StatusCode.UNIMPLEMENTED),
], ids=["DeviceWedgedError", "ValueError", "NotImplementedError"])
def test_exception_to_grpc_matches(make, code):
    port = _status(texc, make(tsched))
    assert port == _status(jexc, make(jsched))
    assert [c for c, _ in port] == [code, code]


def test_device_wedged_error_is_the_copied_schedulers():
    assert texc.DeviceWedgedError is tsched.DeviceWedgedError


# ------------------------------------------------------- protocol stubs


def test_stubs_round_trip():
    """A request built with the port's stubs parses with the JAX package's
    into an equal message, and the reverse."""
    req = tpb.Request(engine_id="sd15", request_id="r1")
    req.prompt.add().text = "a boat"
    req.image.height, req.image.width, req.image.steps = 512, 512, 20
    req.image.seed.append(7)
    req.image.transform.diffusion = tpb.SAMPLER_K_DPMPP_2M
    req.image.parameters.add().sampler.cfg_scale = 7.5
    wire = req.SerializeToString()
    back = jpb.Request.FromString(wire)
    assert back.SerializeToString() == wire
    assert tpb.Request.FromString(back.SerializeToString()) == req
    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tepb.Engines.DESCRIPTOR.full_name == "gooseai.Engines"


def test_registration_names_match():
    for name in ("GENERATION_SERVICE", "ENGINES_SERVICE",
                 "DASHBOARD_SERVICE"):
        assert getattr(treg, name) == getattr(jreg, name)


# ------------------------------------------------------- engines.yaml DSL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("path,flags", [
    ("config/engines.yaml", {}),
    ("config/engines.yaml", {"hbm4": True, "vram4": True}),
    ("tests/fixtures/engines.test.yaml", {}),
], ids=["engines", "engines_hbm4", "fixture"])
def test_engines_yaml_entries_match(path, flags):
    port = tyaml.load(os.path.join(REPO, path), flags)
    assert port == jyaml.load(os.path.join(REPO, path), flags)
    assert any(e.get("id") for e in port)


def test_engines_yaml_templates_match(tmp_path):
    """An !include, a template with params and an id overlay."""
    (tmp_path / "templates.yaml").write_text(
        "- {id: base, abstract: true, task: generate,\n"
        "   model: {path: '{{dir}}', seed: '{{seed:0}}'}}\n")
    (tmp_path / "engines.yaml").write_text(
        "- !include templates.yaml\n"
        "- {id: a, template: base, params: {dir: org/a}}\n"
        "- {id: a, default: true}\n")
    port = tyaml.load(str(tmp_path / "engines.yaml"))
    assert port == jyaml.load(str(tmp_path / "engines.yaml"))
    assert port == [{"id": "a", "task": "generate", "default": True,
                     "model": {"path": "org/a", "seed": "0"}}]


# --------------------------------------------------------- weight resolver


def _chain(mod, root, ref, **kw):
    r = mod.WeightResolver(local_dirs=[str(root / "weights")],
                           hf_cache=str(root), download_cache=str(root / "dl"),
                           **kw)
    return [(c.kind, c.path, c.exists) for c in r.candidates(ref)]


def test_weight_resolver_chains_match(tmp_path):
    (tmp_path / "weights" / "org--model--fp16").mkdir(parents=True)
    (tmp_path / "weights" / "model").mkdir()
    (tmp_path / "hub" / "models--org--hub" / "snapshots" / "abc").mkdir(
        parents=True)
    for ref in ("org/model", "org/model@main", "org/hub", "nobody/none",
                str(tmp_path / "weights"), "./rel",
                "https://civitai.com/api/download/models/567",
                "https://example.com/w.safetensors"):
        for kw in ({}, {"prefer_fp16": False}, {"allow_network": True}):
            assert _chain(tweights, tmp_path, ref, **kw) == \
                _chain(jweights, tmp_path, ref, **kw), (ref, kw)
    port = tweights.WeightResolver(local_dirs=[str(tmp_path / "weights")])
    assert port.resolve("org/model") == str(
        tmp_path / "weights" / "org--model--fp16")


def test_select_repo_files_match():
    files = ["model_index.json", "unet/config.json",
             "unet/diffusion_pytorch_model.bin",
             "unet/diffusion_pytorch_model.safetensors",
             "unet/diffusion_pytorch_model.fp16.safetensors",
             "vae/diffusion_pytorch_model.bin", "text_encoder/model.fp16.bin",
             "text_encoder/model.safetensors", "tokenizer/merges.txt",
             "safety_checker/model.onnx", "README.md", "v1-5.ckpt",
             "v1-5-pruned.safetensors", "v1-5-pruned.fp16.safetensors"]
    for fp16 in (True, False):
        assert tweights.select_repo_files(files, fp16) == \
            jweights.select_repo_files(files, fp16)
        assert tweights.pick_single_checkpoint(files, fp16) == \
            jweights.pick_single_checkpoint(files, fp16)
    assert tweights.parse_civitai_ref("https://civitai.com/models/12") == \
        jweights.parse_civitai_ref("https://civitai.com/models/12")
