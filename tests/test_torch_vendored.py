"""The port's copies of the JAX package's JAX-free modules against their
originals: the model configs, the fallback tokenizer, the coalescing
dispatcher, the exception -> gRPC status map, the protocol stubs, the
service registration, the engines.yaml DSL, the weight resolver, and the
HTTP surface (gRPC-Web framing and client, the multipart parser, the
Stability REST request builder and answers, the OpenAPI document) with
the caches, the resource whitelist, the debug recorder, the log store and
the dashboard. The port imports none of gyre_tpu, so these copies must not
drift; each test runs the same input through both and compares exactly (no
arithmetic is involved, so there is no tolerance).
"""

import base64
import dataclasses
import gzip
import json
import logging
import os
import threading
import time

import grpc
import numpy as np
import pytest

from gyre_tpu.generated import generation_pb2 as jpb
from gyre_tpu.http import grpc_web as jweb
from gyre_tpu.http import grpc_web_client as jwebc
from gyre_tpu.http import router as jrouter
from gyre_tpu.http import stability_rest as jrest
from gyre_tpu.manager import engines_yaml as jyaml
from gyre_tpu.manager import scheduler as jsched
from gyre_tpu.manager import weights as jweights
from gyre_tpu.models import configs as jconfigs
from gyre_tpu.pipeline import tokenizer as jtok
from gyre_tpu.services import dashboard as jdash
from gyre_tpu.services import exception_to_grpc as jexc
from gyre_tpu.services import registration as jreg
from gyre_tpu.utils import cache as jcache
from gyre_tpu.utils import debug_recorder as jrec
from gyre_tpu.utils import logview as jlog
from gyre_tpu.utils import resources as jres
from gyre_tpu_torch.generated import engines_pb2 as tepb
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http import grpc_web as tweb
from gyre_tpu_torch.http import grpc_web_client as twebc
from gyre_tpu_torch.http import router as trouter
from gyre_tpu_torch.http import stability_rest as trest
from gyre_tpu_torch.manager import engines_yaml as tyaml
from gyre_tpu_torch.manager import scheduler as tsched
from gyre_tpu_torch.manager import weights as tweights
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.pipeline import tokenizer as ttok
from gyre_tpu_torch.services import dashboard as tdash
from gyre_tpu_torch.services import exception_to_grpc as texc
from gyre_tpu_torch.services import registration as treg
from gyre_tpu_torch.utils import cache as tcache
from gyre_tpu_torch.utils import debug_recorder as trec
from gyre_tpu_torch.utils import logview as tlog
from gyre_tpu_torch.utils import resources as tres


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


# ---------------------------------------------------- HTTP surface copies

FRAMES = [[], [b""], [b"one"], [b"a" * 70000, b"\x00\x80\xff", b"xyz"]]


@pytest.mark.parametrize("messages", FRAMES, ids=["none", "empty", "one",
                                                  "three"])
@pytest.mark.parametrize("text_mode", [False, True], ids=["binary", "text"])
def test_grpc_web_framing_matches(messages, text_mode):
    def run(mod):
        chunks = list(mod.frame_responses(messages, status=3,
                                          message="bad thing",
                                          text_mode=text_mode))
        ctype = "application/grpc-web-text" if text_mode else \
            "application/grpc-web+proto"
        raw = b"".join(base64.b64decode(c) if text_mode else c
                       for c in chunks)
        body = mod.wrap_message(messages[0] if messages else b"req")
        return (chunks, list(mod.unwrap_message_stream(raw)),
                mod.decode_request_body(
                    base64.b64encode(body) if text_mode else body, ctype),
                mod.encode_trailers(), mod.is_grpc_web(ctype),
                mod.is_grpc_web("application/json"))
    assert run(tweb) == run(jweb)


def test_grpc_web_error_matches():
    for mod in (twebc, jwebc):
        err = mod.GrpcWebError(5, "not found")
        assert (err.status, str(err)) == (5, "grpc-status 5: not found")


def _multipart(boundary: str) -> bytes:
    def part(name, value, filename=None, ctype=None):
        head = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            head += f'; filename="{filename}"'
        if ctype:
            head += f"\r\nContent-Type: {ctype}"
        body = value if isinstance(value, bytes) else str(value).encode()
        return (b"--" + boundary.encode() + b"\r\n" + head.encode() +
                b"\r\n\r\n" + body + b"\r\n")

    return b"".join([
        part("text_prompts[0][text]", "a multipart test"),
        part("text_prompts[0][weight]", "1.0"),
        part("text_prompts[1][text]", "blurry"),
        part("text_prompts[1][weight]", "-1"),
        part("height", "64"), part("seed", "3"),
        part("init_image", b"\x89PNG\x00\x01", "init.png", "image/png"),
        part("mask_image", b"\x00\xff", None, "application/octet-stream"),
        part("", "nameless"),
    ]) + b"--" + boundary.encode() + b"--\r\n"


def test_multipart_and_form_nesting_match():
    ctype = "multipart/form-data; boundary=b0undary"
    port = trouter.parse_multipart(_multipart("b0undary"), ctype)
    assert port == jrouter.parse_multipart(_multipart("b0undary"), ctype)
    assert set(port[1]) == {"init_image", "mask_image"}
    for fields in (port[0], {"a[2]": "x", "a[0]": "y"},
                   {"a[b][0][c]": "1", "a[b][1]": "2", "z": "3"}):
        assert trouter._nest_form_fields(fields) == \
            jrouter._nest_form_fields(fields)


def _png(shape, seed=0):
    rng = np.random.default_rng(seed)
    return timages.encode_png(rng.integers(0, 256, shape, dtype=np.uint8))


REST_BODIES = [
    ("text-to-image", {"text_prompts": [{"text": "a cat"}]}, {}),
    ("text-to-image", {"text_prompts": [{"text": "a", "weight": 0.5},
                                        {"text": "b", "weight": -1}],
                       "height": 768, "width": 640, "steps": 30,
                       "samples": 2, "seed": 2 ** 33 + 5,
                       "sampler": "k_euler", "cfg_scale": 9}, {}),
    ("text-to-image", {"text_prompts": [{"text": "x"}], "sampler": "nope",
                       "seed": 0}, {}),
    ("image-to-image", {"text_prompts": [{"text": "x"}],
                        "init_image": "PNG", "image_strength": 0.6}, {}),
    ("image-to-image", {"text_prompts": [{"text": "x"}],
                        "init_image_mode": "STEP_SCHEDULE",
                        "step_schedule_start": 0.3}, {"init_image": "PNG"}),
    ("masking", {"text_prompts": [{"text": "x"}], "init_image": "RGBA",
                 "mask_source": "INIT_IMAGE_ALPHA"}, {}),
    ("masking", {"text_prompts": [{"text": "x"}],
                 "mask_source": "MASK_IMAGE_BLACK"},
     {"init_image": "PNG", "mask_image": "PNG"}),
    ("masking", {"text_prompts": [{"text": "x"}],
                 "mask_source": "MASK_IMAGE_WHITE", "mask_image": "PNG"},
     {"init_image": "PNG"}),
    ("upscale", {"image": "PNG", "width": 1024}, {}),
    ("text-to-image", {"text_prompts": []}, {}),
    ("text-to-image", {"text_prompts": [{"text": "x"}], "steps": 999}, {}),
    ("image-to-image", {"text_prompts": [{"text": "x"}]}, {}),
    ("masking", {"text_prompts": [{"text": "x"}]}, {"init_image": "PNG"}),
    ("upscale", {}, {}),
]


def _rest_inputs(body, files):
    blobs = {"PNG": _png((32, 48, 3)), "RGBA": _png((32, 48, 4), 1)}

    def fill(v):
        return base64.b64encode(blobs[v]).decode() \
            if isinstance(v, str) and v in blobs else v

    return ({k: fill(v) for k, v in body.items()},
            {k: blobs[v] for k, v in files.items()})


@pytest.mark.parametrize("kind,body,files", REST_BODIES,
                         ids=[f"{i}-{k}" for i, (k, _, _) in
                              enumerate(REST_BODIES)])
def test_stability_rest_build_request_matches(kind, body, files):
    body, files = _rest_inputs(body, files)

    def run(mod):
        try:
            return mod.build_request("eng", body, kind, files
                                     ).SerializeToString()
        except mod.RESTError as e:
            return (e.status, e.name, e.message)
    assert run(trest) == run(jrest)


def _answers(pb, finish):
    out = [pb.Answer(answer_id="empty")]
    for i in range(2):
        ans = pb.Answer(answer_id=f"a{i}")
        ans.artifacts.add(type=pb.ARTIFACT_TEXT, text="t")
        ans.artifacts.add(type=pb.ARTIFACT_IMAGE, binary=b"img%d" % i,
                          seed=10 + i, finish_reason=finish if i else pb.NULL)
        out.append(ans)
    return out


@pytest.mark.parametrize("accept", ["application/json", "image/png"])
def test_stability_rest_answers_to_response_matches(accept):
    assert trest.answers_to_response(_answers(tpb, tpb.FILTER), accept) == \
        jrest.answers_to_response(_answers(jpb, jpb.FILTER), accept)
    for mod in (trest, jrest):
        with pytest.raises(mod.RESTError):
            mod.answers_to_response([], accept)


def _cache_scenario(mod, path):
    c = mod.MemoryLRUCache(max_bytes=3000)
    for k in "abcd":
        c.set(k, b"x" * 1000)                     # d evicts a
    c.set("t", b"y", ttl=0.01)
    c.set("n", np.zeros(10, np.float32))
    time.sleep(0.05)
    lru = (c.get("a"), c.get("d") is not None, c.get("t"), "n" in c,
           c.keys())
    c.expire()
    disk = mod.DiskCache(str(path), max_bytes=10_000)
    dual = mod.DualCache(mod.MemoryLRUCache(max_bytes=100), disk)
    dual.set("key1", b"hello" * 100)
    dual.set("key2", b"world" * 100)
    for i in range(30):
        disk.set(f"fill{i}", b"z" * 1000)         # evicts the oldest
    ks = mod.KeyspacedCache(dual, "gen:")
    ks.set("x", b"1")
    return (lru, c.keys(), dual.get("key2"), ks.get("x"), dual.get("gen:x"),
            disk.get("nope", "miss"), sorted(os.listdir(str(path))) != [])


def test_caches_match(tmp_path):
    assert _cache_scenario(tcache, tmp_path / "t") == \
        _cache_scenario(jcache, tmp_path / "j")


def _resource_scenario(mod, root):
    rp = mod.ResourceProvider(cache=None, local_roots={"models": str(root)})
    out = [rp.fetch("file:models/model.safetensors")]
    for source, rtype, fmt in (
            ("file:other/model.safetensors", "lora", "safetensors"),
            ("https://evil.example.com/x", "lora", "safetensors"),
            ("file:models/../../etc/passwd", "model", "safetensors"),
            ("https://civitai.com/api/download/1", "lora", "safetensors"),
            ("ftp://x/y", "image", "png")):
        try:
            rp.fetch(source, rtype, fmt)
            out.append("fetched")
        except mod.ResourceError as e:
            out.append(str(e))
    out.append([rp.check(s, t, f, n) for s, t, f, n in (
        ("file:a", "lora", "safetensors", 0),
        ("file:a", "image", "png", 0),
        ("https://huggingface.co/x", "model", "safetensors", 9 * 1024 ** 3),
        ("https://huggingface.co/x", "model", "safetensors", 1))])
    rule = mod.WhitelistRule(source="https://*", type="lora", max_size=10)
    out.append([rule.matches("https://a", "lora", "x", 5),
                rule.matches("https://a", "lora", "x", 50),
                rule.matches("http://a", "lora", "x", 5)])
    return out


def test_resource_provider_whitelist_matches(tmp_path):
    (tmp_path / "model.safetensors").write_bytes(b"data")
    assert _resource_scenario(tres, tmp_path) == \
        _resource_scenario(jres, tmp_path)


def _recorder_scenario(mod, path):
    rec = mod.DebugRecorder(str(path), window_s=600.0)
    with rec.record("generate") as store:
        store.store("engine", "e")
        store.store("obj", object)               # not JSON: kept as repr
    with pytest.raises(RuntimeError):
        with rec.record("boom") as store:
            raise RuntimeError("x")
    with mod.DebugNullRecorder().record("n") as store:
        store.store("k", 1)
    out = []
    for f in sorted(os.listdir(str(path)), key=lambda f: f.split("-")[1]):
        with gzip.open(os.path.join(str(path), f), "rt") as fh:
            doc = json.load(fh)
        doc.pop("time")
        out.append((f.split("-")[1], doc))
    return out


def test_debug_recorder_matches(tmp_path):
    port = _recorder_scenario(trec, tmp_path / "t")
    assert port == _recorder_scenario(jrec, tmp_path / "j")
    assert [label for label, _ in port] == ["boom", "generate"]


def test_log_store_and_visual_record_match():
    out = []
    for mod in (tlog, jlog):
        handler = mod.StoreHandler(capacity=3)
        handler.setFormatter(logging.Formatter("%(message)s"))
        log = logging.getLogger(f"vendored-{mod.__name__}")
        log.propagate = False
        log.addHandler(handler)
        try:
            cache = tcache.MemoryLRUCache()
            mod.VisualRecord.cache = cache
            rec = mod.VisualRecord("stage", np.zeros((4, 4, 3), np.uint8))
            for i in range(4):
                log.warning("msg %d", i)
            log.warning(str(rec))
        finally:
            mod.VisualRecord.cache = None
            log.removeHandler(handler)
        out.append(([(r["level"], r["message"].split(" /log/")[0])
                     for r in handler.tail(10)], len(rec.keys),
                    cache.get(rec.keys[0])))
    assert out[0] == out[1]


def test_dashboard_get_me_matches():
    port = tdash.DashboardServiceServicer().GetMe(None, None)
    ref = jdash.DashboardServiceServicer().GetMe(None, None)
    assert port.SerializeToString() == ref.SerializeToString()


def test_openapi_document_is_the_copy():
    assert trouter._openapi_document() == jrouter._openapi_document()
    assert trouter._openapi_document() is not None


@pytest.mark.parametrize("sigma,radius", [(2.0, 6), (0.6, 2), (5.0, 15)])
def test_gaussian_kernel_is_the_copy(sigma, radius):
    """ops/images.py's numpy gaussian kernel, copied from the JAX
    package's module (which imports jax)."""
    from gyre_tpu.ops import images as jimages
    from gyre_tpu_torch.ops import images as timages

    np.testing.assert_array_equal(
        timages._gaussian_kernel1d(sigma, radius),
        jimages._gaussian_kernel1d(sigma, radius))
