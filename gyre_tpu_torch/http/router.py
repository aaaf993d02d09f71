"""HTTP server: REST + JSON gateway + gRPC-WEB + status, on a stdlib
ThreadingHTTPServer (the reference runs Twisted + a WSGI bridge,
gyre/server.py:207-501; dependency-free threads match our gRPC executor
model and the TPU dispatcher owns all device work anyway).

Routes (reference RoutingController parity):
  /server.json                         discovery document
  /status                              engine status JSON
  /v1/engines/list                     Stability REST
  /v1/generation/{engine}/{kind}       Stability REST generation
  /grpcgateway/{Service}/{Method}      JSON-proto gateway
  /{pkg.Service}/{Method}              gRPC-WEB (content-type sniffed)

Copy of gyre_tpu/http/router.py. /profile/start and /profile/stop run
torch.profiler (utils/timing.py) and write under the temporary directory.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import re
import threading
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from google.protobuf import json_format

from ..generated import engines_pb2 as epb
from ..generated import generation_pb2 as gpb
from . import grpc_web, stability_rest

logger = logging.getLogger(__name__)


class FakeGrpcContext:
    """Adapter standing in for a grpc context on HTTP paths (reference
    GRPCContext, gyre/http/grpc_gateway_controller.py:30-72)."""

    def __init__(self):
        self.code = None
        self.details = None
        self._callbacks = []

    def add_callback(self, cb):
        self._callbacks.append(cb)

    def abort(self, code, details):
        self.code, self.details = code, details
        raise AbortError(code, details)

    def set_code(self, code):
        self.code = code

    def set_details(self, details):
        self.details = details


class AbortError(Exception):
    def __init__(self, code, details):
        self.code, self.details = code, details
        super().__init__(details)


def parse_multipart(body: bytes, content_type: str):
    """-> (fields: dict[str,str], files: dict[str,bytes])."""
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    fields, files = {}, {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True)
        if part.get_filename() or part.get_content_type().startswith(
                ("image/", "application/octet")):
            files[name] = payload
        else:
            fields[name] = payload.decode("utf-8", "replace")
    return fields, files


def _nest_form_fields(fields: dict) -> dict:
    """text_prompts[0][text]=... style form fields -> nested dict."""
    out: dict = {}
    for key, value in fields.items():
        parts = re.findall(r"([^\[\]]+)", key)
        cur = out
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            nxt = parts[i + 1] if not last else None
            idx = int(part) if part.isdigit() else part
            if last:
                if isinstance(cur, list):
                    while len(cur) <= idx:
                        cur.append(None)
                    cur[idx] = value
                else:
                    cur[idx] = value
            else:
                container = [] if (nxt and nxt.isdigit()) else {}
                if isinstance(cur, list):
                    while len(cur) <= idx:
                        cur.append(None)
                    if cur[idx] is None:
                        cur[idx] = container
                    cur = cur[idx]
                else:
                    cur = cur.setdefault(idx, container)
    return out


class HttpHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "gyre-tpu"

    # injected by make_server:
    generation = None
    engines = None
    manager = None
    access_keys: dict[str, set] = {}

    def log_message(self, fmt, *args):
        logger.debug("http: " + fmt, *args)

    # ------------------------------------------------------------ plumbing

    def _send(self, status: int, ctype: str, body: bytes,
              extra: dict | None = None):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, status=200):
        self._send(status, "application/json", json.dumps(obj).encode())

    def _authorized(self, accept_basic: bool = False) -> bool:
        """Token check (reference CheckAuthHeaderMixin,
        gyre/server.py:108-120): Bearer always; Basic (user == pass ==
        token) only on accept_basic routes."""
        if not self.access_keys:
            return True
        auth = self.headers.get("Authorization", "")
        m = re.match(r"Bearer\s+(.*)", auth, re.IGNORECASE)
        if m and m.group(1) in self.access_keys:
            return True
        m = re.match(r"Basic\s+(.*)", auth, re.IGNORECASE)
        if accept_basic and m:
            try:
                u, _, p = base64.b64decode(m.group(1)).decode().partition(":")
            except Exception:  # noqa: BLE001
                return False
            if u == p and p in self.access_keys:
                return True
        return False

    def _deny_basic(self):
        """401 + WWW-Authenticate for the browser-facing level-1 routes
        (reference NeedBasicAuthResource, gyre/server.py:338-346)."""
        self._send(401, "text/plain", b"Unauthorized",
                   {"WWW-Authenticate": 'Basic realm="gyre-tpu access token"'})

    def _deny(self):
        self._send_json({"message": "forbidden"}, 403)

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    # -------------------------------------------------------------- verbs

    def do_OPTIONS(self):
        self._send(204, "text/plain", b"", {
            "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
            "Access-Control-Allow-Headers":
                "Authorization, Content-Type, x-grpc-web, x-user-agent",
        })

    image_cache = None
    log_store = None
    proxies: dict[str, str] = {}
    file_root: str | None = None

    def _maybe_proxy(self, method: str) -> bool:
        """Configured reverse proxies (reference gyre/http/reverse_proxy.py):
        /p/<name>/... forwards to the mapped upstream."""
        m = re.match(r"/p/([\w-]+)(/.*)?$", self.path)
        if not m or m.group(1) not in self.proxies:
            return False
        import urllib.request

        upstream = self.proxies[m.group(1)].rstrip("/") + (m.group(2) or "/")
        body = self._body() if method == "POST" else None
        req = urllib.request.Request(upstream, data=body, method=method)
        for k in ("Content-Type", "Accept", "Authorization"):
            if self.headers.get(k):
                req.add_header(k, self.headers[k])
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                self._send(resp.status,
                           resp.headers.get("Content-Type", "text/plain"),
                           resp.read())
        except Exception as e:  # noqa: BLE001
            self._send_json({"message": f"proxy error: {e}"}, 502)
        return True

    def do_GET(self):
        try:
            self._do_get()
        except Exception as e:  # noqa: BLE001
            logger.exception("http error")
            self._send_json({"message": str(e)}, 500)

    def _do_get(self):
        if self._maybe_proxy("GET"):
            return
        path = self.path.split("?")[0]
        # level 1: browser-facing monitoring (basic auth accepted)
        if path == "/log" or path.startswith("/log/") or path == "/status":
            if not self._authorized(accept_basic=True):
                return self._deny_basic()
        if path.startswith("/log/") and self.image_cache is not None:
            data = self.image_cache.get(path[5:])
            if data is None:
                return self._send_json({"message": "not found"}, 404)
            return self._send(200, "image/png", data)
        if path == "/log" and self.log_store is not None:
            return self._send_json({"log": self.log_store.tail(200)})
        if path == "/server.json":
            return self._send_json({
                "name": "gyre-tpu",
                "version": "0.1.0",
                "api": ["grpc", "grpc-web", "stability-rest-v1"],
            })
        if path == "/openapi.json":
            data = _openapi_document()
            if data is not None:
                return self._send(200, "application/json", data)
        if path == "/status":
            from ..utils.timing import STATS

            disp = getattr(self.manager, "dispatcher", None)
            dstats = {}
            if disp is not None:
                sizes = [r for (r, _) in disp.dispatched]
                dstats = {
                    "batches": len(sizes),
                    "coalesced_requests": disp.coalesced_requests,
                    "max_merged_requests": max(sizes, default=0),
                    "interleaved_chunks": disp.interleaved_chunks,
                    "padded_rows": disp.padded_rows,
                    "dispatched": disp.dispatched[-50:],
                    "watchdog": disp.watchdog_state(),
                }
            return self._send_json({"engines": self.manager.status(),
                                    "dispatcher": dstats,
                                    "prewarm": getattr(
                                        self.manager, "prewarm_state",
                                        {"state": "off"}),
                                    "timings": STATS.summary()})
        if path in ("/profile/start", "/profile/stop"):
            import tempfile

            from ..utils import timing

            log_dir = os.path.join(tempfile.gettempdir(), "gyre-profile")
            if path.endswith("start"):
                err = timing.profiler_start(log_dir)
            else:
                err = timing.profiler_stop()
            return self._send_json(
                {"ok": err is None, "error": err, "log_dir": log_dir})
        if re.fullmatch(r"/v1(?:alpha|beta)?/engines/list", path):
            if not self._authorized():
                return self._deny()
            s, ct, body = stability_rest.engines_list_response(self.manager)
            return self._send(s, ct, body)
        if self._serve_file(path):
            return
        if path == "/":
            return self._send(302, "text/plain", b"", {"Location": "/status"})
        self._send_json({"message": "not found"}, 404)

    _MIME = {".html": "text/html", ".htm": "text/html", ".js":
             "application/javascript", ".css": "text/css", ".json":
             "application/json", ".png": "image/png", ".jpg": "image/jpeg",
             ".jpeg": "image/jpeg", ".webp": "image/webp", ".svg":
             "image/svg+xml", ".ico": "image/x-icon", ".txt": "text/plain",
             ".wasm": "application/wasm"}

    def _serve_file(self, path: str) -> bool:
        """Static file root (reference static.File on --http_file_root,
        gyre/server.py:359-369, 1211): overlapped on /, traversal-safe."""
        if not self.file_root:
            return False
        root = os.path.realpath(self.file_root)
        target = os.path.realpath(os.path.join(root, path.lstrip("/")))
        if not (target == root or target.startswith(root + os.sep)):
            return False
        if os.path.isdir(target):
            target = os.path.join(target, "index.html")
        if not os.path.isfile(target):
            return False
        ext = os.path.splitext(target)[1].lower()
        with open(target, "rb") as fh:
            self._send(200, self._MIME.get(ext, "application/octet-stream"),
                       fh.read())
        return True

    def do_POST(self):
        if self._maybe_proxy("POST"):
            return
        path = self.path.split("?")[0]
        ctype = self.headers.get("Content-Type", "")
        try:
            if grpc_web.is_grpc_web(ctype):
                return self._grpc_web(path, ctype)
            m = re.match(r"/(v1(?:alpha|beta)?)/generation/([^/]+)/"
                         r"(?:image-to-image/)?([\w-]+)$", path)
            if m:
                return self._stability_generation(m.group(2), m.group(3),
                                                  ctype)
            m = re.match(r"/grpcgateway/(\w+)/(\w+)$", path)
            if m:
                return self._gateway(m.group(1), m.group(2))
            self._send_json({"message": "not found"}, 404)
        except stability_rest.RESTError as e:
            self._send_json({"id": e.name, "name": e.name,
                             "message": e.message}, e.status)
        except AbortError as e:
            self._send_json({"message": str(e.details)}, 500)
        except Exception as e:  # noqa: BLE001
            logger.exception("http error")
            self._send_json({"message": str(e)}, 500)

    # ------------------------------------------------------------- routes

    def _stability_generation(self, engine_id: str, kind: str, ctype: str):
        if not self._authorized():
            return self._deny()
        spec = next((s for s in self.manager.specs if s.id == engine_id), None)
        if spec is None:
            return self._send_json({"message": "No such engine"}, 404)
        if kind == "upscale":
            if spec.task not in ("upscaler", "upscale"):
                return self._send_json(
                    {"message": "Engine is not a upscaler task engine"}, 400)
        elif spec.task != "generate":
            return self._send_json(
                {"message": "Engine is not a generate task engine"}, 400)
        body_raw = self._body()
        if ctype.startswith("multipart/"):
            fields, files = parse_multipart(body_raw, ctype)
            body = _nest_form_fields(fields)
        else:
            body = json.loads(body_raw or b"{}")
            files = {}
        req = stability_rest.build_request(engine_id, body, kind, files)
        ctx = FakeGrpcContext()
        answers = list(self.generation.Generate(req, ctx))
        accept = self.headers.get("Accept", "application/json")
        if accept not in ("image/png", "application/json"):
            accept = "application/json"
        s, ct, out = stability_rest.answers_to_response(answers, accept)
        self._send(s, ct, out)

    def _gateway(self, service: str, method: str):
        """JSON-proto gateway (reference gyre/http/grpc_gateway.py)."""
        if not self._authorized():
            return self._deny()
        body = json.loads(self._body() or b"{}")
        ctx = FakeGrpcContext()
        if service in ("GenerationService", "generation"):
            if method == "Generate":
                req = json_format.ParseDict(body, gpb.Request(),
                                            ignore_unknown_fields=True)
                stream = self.generation.Generate(req, ctx)
                if "application/x-ndjson" in \
                        self.headers.get("Accept", ""):
                    # stream each Answer as it is produced (the reference
                    # gateway buffers whole responses — VERDICT weak #10;
                    # opt-in so the default array shape stays compatible)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for a in stream:
                        data = json.dumps(
                            json_format.MessageToDict(a)).encode() + b"\n"
                        self.wfile.write(
                            f"{len(data):X}\r\n".encode() + data + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                    return None
                answers = [json_format.MessageToDict(a) for a in stream]
                return self._send_json(answers)
            if method == "AsyncGenerate":
                req = json_format.ParseDict(body, gpb.Request(),
                                            ignore_unknown_fields=True)
                out = self.generation.AsyncGenerate(req, ctx)
                return self._send_json(json_format.MessageToDict(out))
            if method == "AsyncResult":
                req = json_format.ParseDict(body, gpb.AsyncHandle(),
                                            ignore_unknown_fields=True)
                out = self.generation.AsyncResult(req, ctx)
                return self._send_json(json_format.MessageToDict(out))
            if method == "AsyncCancel":
                req = json_format.ParseDict(body, gpb.AsyncHandle(),
                                            ignore_unknown_fields=True)
                out = self.generation.AsyncCancel(req, ctx)
                return self._send_json(json_format.MessageToDict(out))
        if service in ("EnginesService", "engines") and method == "ListEngines":
            req = json_format.ParseDict(body, epb.ListEnginesRequest(),
                                        ignore_unknown_fields=True)
            out = self.engines.ListEngines(req, ctx)
            return self._send_json(json_format.MessageToDict(out))
        self._send_json({"message": f"unknown rpc {service}/{method}"}, 404)

    def _grpc_web(self, path: str, ctype: str):
        if not self._authorized():
            return self._deny()
        m = re.match(r"/([\w.]+)/(\w+)$", path)
        if not m:
            return self._send_json({"message": "bad grpc-web path"}, 404)
        service, method = m.group(1), m.group(2)
        payload = grpc_web.decode_request_body(self._body(), ctype)
        ctx = FakeGrpcContext()
        text_mode = "text" in ctype
        try:
            if service.endswith("GenerationService") and method == "Generate":
                req = gpb.Request.FromString(payload)
                msgs = [a.SerializeToString()
                        for a in self.generation.Generate(req, ctx)]
            elif service.endswith("EnginesService") and \
                    method == "ListEngines":
                req = epb.ListEnginesRequest.FromString(payload)
                msgs = [self.engines.ListEngines(req, ctx)
                        .SerializeToString()]
            else:
                return self._send_json(
                    {"message": f"unknown rpc {service}/{method}"}, 404)
            chunks = b"".join(grpc_web.frame_responses(msgs,
                                                       text_mode=text_mode))
        except AbortError as e:
            chunks = b"".join(grpc_web.frame_responses(
                [], status=int(getattr(e.code, "value", [13])[0])
                if hasattr(e.code, "value") else 13,
                message=str(e.details), text_mode=text_mode))
        self._send(200, ctype, chunks)


def _openapi_document() -> bytes | None:
    """The packaged REST OpenAPI description (reference ships
    gyre/generated/stablecabal.openapi.json)."""
    path = os.path.join(os.path.dirname(__file__), "..", "generated",
                        "stablecabal.openapi.json")
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError:
        return None


def make_http_server(host: str, port: int, *, manager, generation, engines,
                     access_keys=None, image_cache=None,
                     log_store=None, proxies=None,
                     file_root=None) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (HttpHandler,), {
        "manager": manager,
        "generation": generation,
        "engines": engines,
        "access_keys": set(access_keys or []) or {},
        "image_cache": image_cache,
        "log_store": log_store,
        "proxies": dict(proxies or {}),
        "file_root": file_root,
    })
    return ThreadingHTTPServer((host, port), handler)


def start_http_server(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
