"""The port's server started as a user starts it, ``main`` with its flags, on
a thread (as tests/test_server.py starts the JAX one), on the CPU with
``--device cpu --dtype float32`` and the tiny engine of
tests/fixtures/engines.test.yaml, behind an access token: client.py,
unchanged, over gRPC, gRPC-Web, Async and WebP; the HTTP router's routes
(Stability REST, the JSON gateway, gRPC-Web, /status, /log, the OpenAPI
document, /profile, static files, a reverse proxy) and its three auth
levels; the source watcher and the localtunnel and NSFW flags.
"""

import base64
import importlib.util
import json
import os
import signal
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import grpc
import numpy as np
import pytest

from gyre_tpu_torch import server as tserver
from gyre_tpu_torch.generated import generation_pb2 as pb
from gyre_tpu_torch.http import grpc_web, stability_rest
from gyre_tpu_torch.ops import images as I
from test_torch_modes import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "sekrit"
BEARER = {"Authorization": f"Bearer {TOKEN}"}
BASIC = {"Authorization": "Basic " +
         base64.b64encode(f"{TOKEN}:{TOKEN}".encode()).decode()}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _client_mod():
    """The repo-root client.py, imported by its path."""
    if "client" in sys.modules and hasattr(sys.modules["client"], "main"):
        return sys.modules["client"]
    spec = importlib.util.spec_from_file_location(
        "client", os.path.join(REPO, "client.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["client"] = mod
    spec.loader.exec_module(mod)
    return mod


class _Upstream(BaseHTTPRequestHandler):
    def do_GET(self):
        body = json.dumps({"upstream": True, "path": self.path}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    saved = dict(stability_rest.LIMITS)
    stability_rest.LIMITS["height"] = (64, 2048)
    stability_rest.LIMITS["width"] = (64, 2048)
    root = tmp_path_factory.mktemp("www")
    (root / "index.html").write_text("<h1>gyre</h1>")
    (root.parent / "secret.txt").write_text("x")
    upstream = HTTPServer(("localhost", 0), _Upstream)
    threading.Thread(target=upstream.serve_forever, daemon=True).start()
    cache = str(tmp_path_factory.mktemp("cache"))
    grpc_port, http_port = _free_port(), _free_port()
    argv = ["--grpc_port", str(grpc_port), "--http_port", str(http_port),
            "--enginecfg", os.path.join(REPO, "tests", "fixtures",
                                        "engines.test.yaml"),
            "--device", "cpu", "--dtype", "float32", "--cache_path", cache,
            "--batch_max", "2", "--access_token", TOKEN,
            "--http_file_root", str(root), "--debug_recording",
            "--proxy", f"ui=http://localhost:{upstream.server_address[1]}"]
    stop = threading.Event()
    thread = threading.Thread(target=tserver.main, args=(argv, stop),
                              daemon=True)
    thread.start()
    url = f"http://localhost:{http_port}"
    deadline = time.monotonic() + 120
    while True:
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/status", headers=BEARER), timeout=2) as r:
                if all(e["ready"] for e in json.loads(r.read())["engines"]):
                    break
        except (OSError, ValueError):
            pass
        if time.monotonic() > deadline or not thread.is_alive():
            pytest.fail("server did not come up")
        time.sleep(0.2)
    yield {"grpc": grpc_port, "http": http_port, "url": url, "cache": cache}
    stop.set()
    thread.join(30)
    upstream.shutdown()
    stability_rest.LIMITS.update(saved)
    assert not thread.is_alive()


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(url, body, headers=None):
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
        headers = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# ---------------------------------------------------------------- client.py


@pytest.mark.parametrize("mode", ["grpc", "grpc_web", "async",
                                  "accept_webp"])
def test_client_gets_an_image(served, tmp_path, mode):
    client = _client_mod()
    host = served["http"] if mode == "grpc_web" else served["grpc"]
    extra = {"grpc": [], "grpc_web": ["--grpc_web"], "async": ["--async"],
             "accept_webp": ["--accept_webp"]}[mode]
    out = tmp_path / "gen.png"
    sigint = signal.getsignal(signal.SIGINT)   # --async installs its own
    try:
        rc = client.main(["a client test", "--host", f"localhost:{host}",
                          "-W", "64", "-H", "64", "--steps", "2", "-S", "5",
                          "--key", TOKEN, "-o", str(out), *extra])
    finally:
        signal.signal(signal.SIGINT, sigint)
    assert rc == 0
    if mode == "accept_webp":
        data = (tmp_path / "gen.webp").read_bytes()
        assert data[:4] == b"RIFF" and data[8:12] == b"WEBP"
    else:
        assert I.decode_png(out.read_bytes()).shape == (1, 64, 64, 3)


def test_client_lists_engines(served, capsys):
    rc = _client_mod().main(["x", "--host", f"localhost:{served['grpc']}",
                             "--key", TOKEN, "--list-engines"])
    assert rc == 0
    assert "test-engine" in capsys.readouterr().out


def test_client_without_the_key_is_refused(served, tmp_path):
    client = _client_mod()
    args = ["x", "--host", f"localhost:{served['grpc']}", "-W", "64", "-H",
            "64", "--steps", "2", "-o", str(tmp_path / "x.png")]
    with pytest.raises(grpc.RpcError) as err:
        client.main(args)
    assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
    with pytest.raises(grpc.RpcError) as err:
        client.main(args + ["--key", "wrong"])
    assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
    with pytest.raises(urllib.error.HTTPError) as err:
        client.main(args[:2] + [f"localhost:{served['http']}",
                                "--grpc_web"] + args[3:])
    assert err.value.code == 403


# --------------------------------------------------------------- HTTP router


def test_status_server_json_and_log(served):
    url = served["url"]
    status, _, body = _get(url + "/server.json")          # level 0: open
    assert status == 200 and "stability-rest-v1" in json.loads(body)["api"]
    status, _, body = _get(url + "/status", BEARER)
    doc = json.loads(body)
    assert [(e["id"], e["ready"], e["weights"]) for e in doc["engines"]] == \
        [("test-engine", True, "random")]
    assert {"coalesced_requests", "interleaved_chunks", "padded_rows",
            "dispatched", "watchdog"} <= set(doc["dispatcher"])
    assert doc["dispatcher"]["watchdog"]["wedged"] is False
    assert doc["prewarm"] == {"state": "off"}
    status, _, body = _get(url + "/log", BEARER)
    assert any("engines ready" in e["message"]
               for e in json.loads(body)["log"])


def test_rest_engines_list(served):
    status, _, body = _get(served["url"] + "/v1/engines/list", BEARER)
    assert status == 200
    assert json.loads(body) == [{"id": "test-engine",
                                 "name": "Tiny Test Engine",
                                 "description": "random-init tiny engine "
                                                "for server tests",
                                 "type": "PICTURE"}]


@pytest.mark.parametrize("accept", ["application/json", "image/png"])
def test_rest_text_to_image(served, accept):
    status, headers, body = _post(
        served["url"] + "/v1/generation/test-engine/text-to-image",
        json.dumps({"text_prompts": [{"text": "a cat"},
                                     {"text": "blurry", "weight": -1}],
                    "height": 64, "width": 64, "steps": 2, "seed": 7,
                    "cfg_scale": 7.5}).encode(),
        {**BEARER, "Content-Type": "application/json", "Accept": accept})
    assert status == 200, body
    assert headers["Content-Type"] == accept
    if accept == "image/png":
        png = body
    else:
        (art,) = json.loads(body)["artifacts"]
        assert art["seed"] == 7 and art["finishReason"] == "NULL"
        png = base64.b64decode(art["base64"])
    assert I.decode_png(png).shape == (1, 64, 64, 3)
    assert I.png_metadata(png)["seed"] == "7"


def test_rest_image_to_image(served):
    """REST image-to-image answers a PNG of the init image's size."""
    init = base64.b64encode(I.encode_png(
        np.full((64, 64, 3), 128, np.uint8))).decode()
    status, headers, body = _post(
        served["url"] + "/v1/generation/test-engine/image-to-image",
        json.dumps({"text_prompts": [{"text": "a cat"}], "height": 64,
                    "width": 64, "steps": 2, "seed": 9, "init_image": init,
                    "image_strength": 0.4}).encode(),
        {**BEARER, "Content-Type": "application/json",
         "Accept": "image/png"})
    assert status == 200, body
    assert headers["Content-Type"] == "image/png"
    assert I.decode_png(body).shape == (1, 64, 64, 3)


def test_rest_masking_keeps_the_unmasked_area(served):
    """REST image-to-image/masking: where the mask is black (kept), the
    answer is the init image's pixels."""
    init = np.full((64, 64, 3), 90, np.uint8)
    mask = np.zeros((64, 64, 3), np.uint8)
    mask[24:56, 24:56] = 255                      # white: regenerate
    status, headers, body = _post(
        served["url"] + "/v1/generation/test-engine/image-to-image/masking",
        json.dumps({"text_prompts": [{"text": "a cat"}], "height": 64,
                    "width": 64, "steps": 2, "seed": 9,
                    "init_image": base64.b64encode(
                        I.encode_png(init)).decode(),
                    "mask_image": base64.b64encode(
                        I.encode_png(mask)).decode(),
                    "mask_source": "MASK_IMAGE_WHITE"}).encode(),
        {**BEARER, "Content-Type": "application/json",
         "Accept": "image/png"})
    assert status == 200, body
    px = np.round(I.decode_png(body)[0] * 255)
    assert px.shape == (64, 64, 3) and (px[:8] == 90).all()


def test_grpc_gateway(served):
    url = served["url"] + "/grpcgateway"
    status, _, body = _post(url + "/EnginesService/ListEngines", {}, BEARER)
    assert status == 200
    (engine,) = json.loads(body)["engine"]
    assert engine["id"] == "test-engine" and engine["ready"]
    # an Async handle made over gRPC answers over the gateway: one servicer
    channel = grpc.insecure_channel(f"localhost:{served['grpc']}")
    req = pb.Request(engine_id="test-engine", request_id="gw")
    req.prompt.add().text = "gateway"
    req.image.height = req.image.width = 64
    req.image.steps = 2
    req.image.seed.append(3)
    handle = channel.unary_unary(
        "/gooseai.GenerationService/AsyncGenerate",
        request_serializer=pb.Request.SerializeToString,
        response_deserializer=pb.AsyncHandle.FromString)(
            req, metadata=[("authorization", TOKEN)], timeout=60)
    channel.close()
    answers, deadline = [], time.monotonic() + 120
    while time.monotonic() < deadline:
        status, _, body = _post(url + "/GenerationService/AsyncResult",
                                {"asyncHandle": handle.async_handle}, BEARER)
        doc = json.loads(body)
        answers += doc.get("answer", [])
        if doc.get("complete"):
            break
    assert status == 200 and len(answers) == 1
    assert answers[0]["artifacts"][0]["seed"] == 3


def _b64_frames(body: bytes) -> bytes:
    """A grpc-web-text body decoded: each frame is base64-encoded apart, so
    padding may end a frame inside the stream; decode segment by
    segment (each segment a multiple of 4 characters)."""
    out, start = b"", 0
    for end in range(4, len(body) + 1, 4):
        if body[end - 1:end] == b"=" or end == len(body):
            out += base64.b64decode(body[start:end])
            start = end
    return out


def test_grpc_web_text_mode(served):
    req = pb.Request(engine_id="test-engine")
    req.prompt.add().text = "text mode"
    req.image.height = req.image.width = 64
    req.image.steps = 2
    req.image.seed.append(4)
    payload = base64.b64encode(grpc_web.wrap_message(req.SerializeToString()))
    status, _, body = _post(
        served["url"] + "/gooseai.GenerationService/Generate", payload,
        {**BEARER, "Content-Type": "application/grpc-web-text+proto"})
    assert status == 200
    frames = list(grpc_web.unwrap_message_stream(_b64_frames(body)))
    data = [d for f, d in frames if not f & grpc_web.TRAILER_FLAG]
    assert pb.Answer.FromString(data[0]).artifacts[0].seed == 4
    assert b"grpc-status: 0" in frames[-1][1]


def test_openapi_document(served):
    status, _, body = _get(served["url"] + "/openapi.json")
    doc = json.loads(body)
    assert status == 200 and doc["openapi"].startswith("3.")
    assert "/v1/generation/{engine_id}/text-to-image" in doc["paths"]


def test_three_auth_levels(served):
    url = served["url"]
    assert _get(url + "/server.json")[0] == 200                  # level 0
    status, headers, _ = _get(url + "/status")                   # level 1
    assert status == 401 and "Basic" in headers["WWW-Authenticate"]
    assert _get(url + "/status", BASIC)[0] == 200
    gateway = url + "/grpcgateway/EnginesService/ListEngines"    # level 2
    assert _post(gateway, {})[0] == 403
    assert _post(gateway, {}, BASIC)[0] == 403
    assert _post(gateway, {}, BEARER)[0] == 200
    assert _get(url + "/v1/engines/list")[0] == 403


def test_static_files_and_proxy(served):
    url = served["url"]
    status, _, body = _get(url + "/index.html")
    assert status == 200 and b"gyre" in body
    assert _get(url + "/../secret.txt")[0] == 404
    status, _, body = _get(url + "/p/ui/some/page")
    assert status == 200
    assert json.loads(body) == {"upstream": True, "path": "/some/page"}


def test_profile_routes(served):
    status, _, body = _get(served["url"] + "/profile/start")
    start = json.loads(body)
    assert status == 200 and start["ok"], start
    status, _, body = _get(served["url"] + "/profile/stop")
    stop = json.loads(body)
    assert stop["ok"], stop
    traces = [f for f in os.listdir(stop["log_dir"])
              if f.startswith("trace-")]
    assert traces
    for f in traces:
        os.remove(os.path.join(stop["log_dir"], f))


def test_debug_recording(served):
    debug = os.path.join(served["cache"], "debug")
    assert any("-generate-" in f for f in os.listdir(debug))


# ------------------------------------------------------------------ flags


def test_source_watcher_detects_changes(tmp_path):
    cfg = tmp_path / "engines.yaml"
    cfg.write_text("- id: a\n")
    watcher = tserver.SourceWatcher(extra_paths=[str(tmp_path)])
    assert watcher.changed() == []          # baseline scan
    assert watcher.changed() == []          # no changes
    cfg.write_text("- id: b\n")
    os.utime(cfg, (os.stat(cfg).st_atime, time.time() + 5))
    assert str(cfg) in watcher.changed()


def test_source_watcher_reexecs_the_server_as_a_module(tmp_path,
                                                       monkeypatch):
    """A restart runs ``python -m gyre_tpu_torch.server`` with the server's
    own arguments: run by its path, server.py fails on its first relative
    import."""
    calls = []
    monkeypatch.setattr(os, "execv", lambda *a: calls.append(a))
    cfg = tmp_path / "engines.yaml"
    cfg.write_text("- id: a\n")
    watcher = tserver.SourceWatcher(extra_paths=[str(tmp_path)],
                                    argv=["--device", "cpu", "--reload"])
    watcher.changed()                       # baseline scan
    watcher.poll()
    assert calls == []
    os.utime(cfg, (os.stat(cfg).st_atime, time.time() + 5))
    watcher.poll()
    assert calls == [(sys.executable,
                      [sys.executable, "-m", "gyre_tpu_torch.server",
                       "--device", "cpu", "--reload"])]


def test_localtunnel_flag_forces_token():
    args = tserver.parse_args(["--localtunnel"])
    assert args.localtunnel and len(args.access_token) >= 16
    assert tserver.parse_args(["--localtunnel", "--access_token", "k"]
                              ).access_token == "k"
    assert tserver.parse_args([]).access_token is None


def test_localtunnel_missing_npx(monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda _: None)
    assert tserver.start_localtunnel(5000, "tok") is None


def test_nsfw_block_exits_naming_c6(tmp_path, caplog):
    """--nsfw_behaviour block without a trained safety checker exits with
    code 2 (fail closed), as the JAX server does; with one configured (a
    `safety_checker:` key; the checker ported under ROADMAP C6) the server
    starts, loads it and serves until stopped."""
    import logging

    from gyre_tpu_torch.models.load import write_safetensors
    from gyre_tpu_torch.pipeline.safety import SafetyChecker

    with pytest.raises(SystemExit) as err:
        tserver.main(["--nsfw_behaviour", "block", "--device", "cpu",
                      "--cache_path", str(tmp_path)])
    assert err.value.code == 2
    assert "requires trained safety-checker" in caplog.text
    checker = tmp_path / "checker.safetensors"
    write_safetensors(str(checker),
                      SafetyChecker.random(device="cpu").state_dict())
    cfg = tmp_path / "engines.yaml"
    cfg.write_text("- {id: tiny, model: preset/test, safety_checker: "
                   f"{checker}}}\n")
    stop = threading.Event()
    stop.set()                       # serve, load, then shut down at once
    caplog.clear()
    with caplog.at_level(logging.INFO):
        tserver.main(["--nsfw_behaviour", "block", "--device", "cpu",
                      "--dtype", "float32", "--enginecfg", str(cfg),
                      "--grpc_port", str(_free_port()), "--http_port",
                      str(_free_port()), "--cache_path", str(tmp_path)],
                     stop)
    assert "safety checker loaded" in caplog.text
    assert "engines ready" in caplog.text
