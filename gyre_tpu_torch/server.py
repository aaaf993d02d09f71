"""gRPC and HTTP server of the PyTorch/CUDA port.

    python -m gyre_tpu_torch.server [--enginecfg config/engines.yaml]
        [--weight_root DIR] [--engine_id ID] [--device cuda]
        [--grpc_port 50051] [--http_port 5000] [--access_token KEY] ...

Serves gooseai.GenerationService (Generate, ChainGenerate and the Async
trio), gooseai.EnginesService and gooseai.DashboardService over gRPC, and
the HTTP router (http/router.py: Stability REST, the JSON gateway,
gRPC-Web, /status, /log, static files and reverse proxies) on one device
or a mesh of them.
The flags are the JAX server's (gyre_tpu/server.py), with its names,
``SD_*`` environment variables and defaults: --enginecfg names an
engines.yaml in the DSL (default ``config/engines.yaml``; one random-weight
SD 1.5 engine when the file is missing), --weight_root the directories
model references resolve in, --save_safetensors ENGINE_ID:PATH exports an
engine and exits, --access_token guards both servers. --device defaults to
cuda and refuses to start without a CUDA device; --device cpu runs the same
path on the CPU (for tests at small presets). --tp (``SD_TP``, default 1)
is the tensor-parallel width of the device mesh, as in the JAX server:
with --device cuda and more than one visible GPU, or with --tp > 1, the
engines run on a mesh (parallel/mesh.py) over every visible GPU, tp GPUs a
dp group; --device cuda:N or cpu keeps that one device unless --tp > 1,
which puts all tp shards on it (the CPU tests' layout). The JAX server's
--platform is not the port's. --nsfw_behaviour block exits with
code 2 unless engines.yaml configures a trained safety checker (a
``task: safety`` engine or a ``safety_checker:`` key), as the JAX server
does; flag without one flags nothing.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time
from concurrent import futures
from dataclasses import dataclass

logger = logging.getLogger("gyre_tpu_torch")

DEFAULT_ENGINES = [{"id": "stable-diffusion-v1-5", "name": "SD 1.5",
                    "model": "preset/sd15", "default": True}]


def environ_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def environ_list(name: str) -> list[str]:
    v = os.environ.get(name, "")
    return [s for s in (x.strip() for x in v.split(",")) if s]


def parse_args(argv=None):
    p = argparse.ArgumentParser("gyre_tpu_torch server")
    net = p.add_argument_group("networking")
    net.add_argument("--grpc_port", type=int,
                     default=int(os.environ.get("SD_GRPC_PORT", 50051)))
    net.add_argument("--http_port", type=int,
                     default=int(os.environ.get("SD_HTTP_PORT", 5000)))
    net.add_argument("--listen_to_all", action="store_true",
                     default=environ_bool("SD_LISTEN_TO_ALL"),
                     help="bind every interface (default: localhost only)")
    net.add_argument("--access_token", type=str,
                     default=os.environ.get("SD_ACCESS_TOKEN") or None)
    net.add_argument("--proxy", action="append", dest="proxies",
                     default=environ_list("SD_PROXY") or None,
                     help="name=url reverse proxy mappings (/p/<name>/...)")
    net.add_argument("--http_file_root", type=str,
                     default=os.environ.get("SD_HTTP_FILE_ROOT", ""),
                     help="serve static files from this directory at /")
    net.add_argument("--localtunnel", action="store_true",
                     default=environ_bool("SD_LOCALTUNNEL"),
                     help="expose the HTTP port through localtunnel.me "
                          "(requires npx; forces an access token)")
    net.add_argument("--reload", action="store_true",
                     default=environ_bool("SD_RELOAD"),
                     help="restart the server when source or config "
                          "files change")

    gen = p.add_argument_group("generation")
    gen.add_argument("--enginecfg", type=str,
                     default=os.environ.get("SD_ENGINECFG",
                                            "config/engines.yaml"))
    gen.add_argument("--engine_id", action="append", dest="engine_ids",
                     default=environ_list("SD_ENGINE_ID") or None,
                     help="only enable these engine ids")
    gen.add_argument("--batch_max", type=str,
                     default=os.environ.get("SD_BATCH_MAX", "4"),
                     help="max merged batch per dispatch, or 'auto' to "
                          "measure it from one UNet call's peak memory at "
                          "startup")
    gen.add_argument("--interleave", type=int,
                     default=int(os.environ.get("SD_INTERLEAVE", "2")),
                     help="max concurrently-active batches the dispatcher "
                          "round-robins at chunk granularity (1 = serial)")
    gen.add_argument("--watchdog", type=float,
                     default=float(os.environ.get("SD_WATCHDOG", "900")),
                     help="seconds a single device op may stay in flight "
                          "before the dispatcher declares the device "
                          "wedged; 0 disables")
    gen.add_argument("--gather_ms", type=float,
                     default=float(os.environ.get("SD_GATHER_MS", "10")),
                     help="coalescer gather window after the first queued "
                          "request")
    gen.add_argument("--grpc_workers", type=int,
                     default=int(os.environ.get("SD_GRPC_WORKERS", 16)),
                     help="gRPC thread pool size; must exceed batch_max "
                          "or the coalescer can never fill a batch from "
                          "concurrent clients")
    gen.add_argument("--nsfw_behaviour", type=str,
                     choices=["block", "flag", "ignore"],
                     default=os.environ.get("SD_NSFW_BEHAVIOUR", "flag"),
                     help="what to do with images the safety checker "
                          "flags: block blacks them out and needs a "
                          "trained checker in engines.yaml; flag marks "
                          "them (FILTER); ignore skips the check")
    gen.add_argument("--save_safetensors", type=str, default=None,
                     metavar="ENGINE_ID:PATH",
                     help="export an engine's weights as a diffusers-layout "
                          "safetensors directory and exit")

    dev = p.add_argument_group("device")
    dev.add_argument("--device", type=str, default="cuda",
                     help="torch device the engines run on")
    dev.add_argument("--tp", type=int,
                     default=int(os.environ.get("SD_TP", 1)),
                     help="tensor-parallel width of the device mesh")
    dev.add_argument("--dtype", type=str, default="bfloat16",
                     choices=["bfloat16", "float32"])
    dev.add_argument("--hbm_optimisation_level", "-V", type=int,
                     default=int(os.environ.get(
                         "SD_HBM_OPTIMISATION_LEVEL",
                         os.environ.get("SD_VRAM_OPTIMISATION_LEVEL", 3))),
                     help="sets the hbm{N} (and reference-compatible "
                          "vram{N}) config include flags for N <= level, "
                          "e.g. the limit_hbm.yaml overlay at level >= 4")
    dev.add_argument("--prewarm", type=str, default=os.environ.get(
        "SD_PREWARM", "auto"), choices=["auto", "on", "off", "full"],
        help="run the default engine's serving request once in the "
             "background after startup (auto = on with a CUDA device); "
             "'full' also runs the dispatcher's max batch")

    res = p.add_argument_group("resources")
    res.add_argument("--cache_path", type=str,
                     default=os.environ.get("SD_CACHE_PATH", "/tmp/gyre-cache"),
                     help="weight downloads go to <cache_path>/weights, "
                          "debug recordings to <cache_path>/debug")
    res.add_argument("--cache_ram", type=int,
                     default=int(os.environ.get("SD_CACHE_RAM", 500)),
                     help="memory cache budget, MB")
    res.add_argument("--local_resource", action="append",
                     dest="local_resources",
                     default=environ_list("SD_LOCAL_RESOURCE") or None,
                     help="prefix=path local resource mappings: a url "
                          "artifact file:<prefix>/<file> reads <path>/<file>")
    res.add_argument("--allow_network_resources", action="store_true",
                     default=environ_bool("SD_ALLOW_NETWORK_RESOURCES"))
    res.add_argument("--weight_root", action="append", dest="weight_roots",
                     default=environ_list("SD_WEIGHT_ROOT") or None,
                     help="local directories searched for model weights")
    res.add_argument("--refresh_models", action="append",
                     dest="refresh_models",
                     default=environ_list("SD_REFRESH_MODELS") or None,
                     help="model refs to force re-download at startup")

    dbg = p.add_argument_group("debug")
    dbg.add_argument("--vram_debug", action="store_true",
                     default=environ_bool("SD_VRAM_DEBUG"),
                     help="accepted for the JAX server's command lines; "
                          "unused, as there")
    dbg.add_argument("--debug_recording", action="store_true",
                     default=environ_bool("SD_DEBUG_RECORDING"),
                     help="keep the last 10 minutes of requests as gzipped "
                          "JSON under <cache_path>/debug")
    dbg.add_argument("--log_level", type=str,
                     default=os.environ.get("SD_LOG_LEVEL", "INFO"))
    args = p.parse_args(argv)
    if args.localtunnel and not args.access_token:
        # a public tunnel is never open without a token
        import secrets

        args.access_token = secrets.token_urlsafe(16)
    return args


def resolve_enginecfg(path: str) -> str:
    """Resolve --enginecfg conveniences (reference gyre/server.py:980-1030):
    an http(s) URL downloads a zip (or bare yaml) into a temp dir; a
    directory means `<dir>/engines.yaml`. When the target is an
    `engines.yaml` outside the packaged config tree, sync shipped dist
    configs into its directory first (engines_yaml.check_and_update)."""
    import tempfile
    import zipfile

    from .manager import engines_yaml

    if path.startswith(("http://", "https://")):
        logger.warning("loading config from a URL; make sure you trust it")
        import urllib.request
        tmp = tempfile.mkdtemp(prefix="gyre-cfg-")
        blob = os.path.join(tmp, "config.bin")
        with urllib.request.urlopen(path, timeout=60) as resp, \
                open(blob, "wb") as fh:
            fh.write(resp.read())
        if zipfile.is_zipfile(blob):
            with zipfile.ZipFile(blob) as zh:
                zh.extractall(tmp)
            path = os.path.join(tmp, "engines.yaml")
            if not os.path.exists(path):
                raise RuntimeError("zip config did not contain engines.yaml")
        else:
            path = os.path.join(tmp, "engines.yaml")
            os.rename(blob, path)
        return path

    if os.path.isdir(path):
        path = os.path.join(path, "engines.yaml")

    if os.path.basename(path) == "engines.yaml":
        dist_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "config")
        user_dir = os.path.dirname(os.path.abspath(path)) or "."
        if os.path.isdir(dist_dir) and \
                os.path.realpath(user_dir) != os.path.realpath(dist_dir):
            try:
                changed = engines_yaml.check_and_update(dist_dir, user_dir)
                if changed:
                    logger.info("dist config update: %s", ", ".join(changed))
            except OSError as e:
                logger.warning("dist config update failed: %s", e)
    return path


def build_mesh(args):
    """The device mesh of --device and --tp (parallel/mesh.py), or None
    for one device: --device cuda with several visible GPUs, or --tp > 1,
    makes one; cuda meshes every visible GPU, cuda:N and cpu repeat that
    device tp times. A mesh that cannot be made is logged and the server
    runs on one device, as the JAX server does."""
    import torch

    from .parallel import mesh as pmesh

    device = torch.device(args.device)
    tp = max(int(args.tp or 1), 1)
    whole = device.type == "cuda" and device.index is None
    if not (tp > 1 or (whole and torch.cuda.device_count() > 1)):
        return None
    try:
        return pmesh.make_mesh(None if whole else [device] * tp, tp=tp)
    except AssertionError as e:
        logger.warning("mesh init failed (%s); single device", e)
        return None


def build_manager(args):
    """The EngineManager of parsed arguments: engine entries from
    --enginecfg (with the hbm/vram include flags of -V), filtered by
    --engine_id, on --device (or the mesh of --device and --tp) in
    --dtype, weights resolved under --weight_root."""
    import torch

    from .manager import engines_yaml
    from .manager.manager import EngineManager
    from .manager.weights import WeightResolver

    args.enginecfg = resolve_enginecfg(args.enginecfg)
    if os.path.exists(args.enginecfg):
        # memory-optimisation include flags: hbm{N}, and vram{N} so that
        # configs written against the reference's `!include(vram4)` work
        level = int(args.hbm_optimisation_level or 0)
        flags = {}
        for i in range(2, 6):
            flags[f"hbm{i}"] = level >= i
            flags[f"vram{i}"] = level >= i
        entries = engines_yaml.load(args.enginecfg, flags)
    else:
        logger.warning("engine config %s not found; using default engine",
                       args.enginecfg)
        entries = [dict(e) for e in DEFAULT_ENGINES]
    if args.engine_ids:
        for e in entries:
            if e.get("id") not in args.engine_ids:
                e["enabled"] = False

    resolver = WeightResolver(
        local_dirs=args.weight_roots or ["./weights"],
        download_cache=os.path.join(args.cache_path or "/tmp/gyre-cache",
                                    "weights"),
        allow_network=args.allow_network_resources)
    for ref in args.refresh_models or []:
        try:
            resolver.resolve(ref, refresh=True)
        except OSError as e:
            logger.warning("refresh of %s failed: %s", ref, e)
    batch_max = 4 if str(args.batch_max) == "auto" \
        else int(args.batch_max)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    mesh = build_mesh(args)
    if mesh is not None:
        logger.info("device mesh %s: %s", mesh.shape,
                    [[str(d) for d in row] for row in mesh.grid])
    return EngineManager(entries, device=args.device, compute_dtype=dtype,
                         batch_max=batch_max, weight_resolver=resolver,
                         interleave=int(args.interleave),
                         gather_ms=float(args.gather_ms),
                         watchdog_s=float(args.watchdog), mesh=mesh)


class TokenAuthInterceptor:
    """gRPC bearer-token check: a call whose ``authorization`` metadata is
    not the token (with or without "Bearer ") is UNAUTHENTICATED."""

    def __init__(self, token: str):
        import grpc

        self.token = token
        self._abort = grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: ctx.abort(grpc.StatusCode.UNAUTHENTICATED,
                                       "invalid token"))

    def intercept_service(self, continuation, handler_call_details):
        meta = dict(handler_call_details.invocation_metadata)
        auth = meta.get("authorization", "")
        key = auth[7:] if auth.startswith("Bearer ") else auth
        if key == self.token:
            return continuation(handler_call_details)
        return self._abort


def build_server(manager, port: int, batch_max: int = 4,
                 host: str = "[::]", workers: int = 16, *,
                 generation=None, engines=None,
                 access_token: str | None = None):
    """A started grpc.Server serving ``manager``'s Generation, Engines and
    Dashboard services, behind TokenAuthInterceptor when ``access_token``
    is given; returns (server, port). ``generation`` and ``engines`` are
    servicers to share with the HTTP router (new ones by default)."""
    import grpc

    from .services import registration
    from .services.dashboard import DashboardServiceServicer
    from .services.engines import EnginesServiceServicer
    from .services.generate import GenerationServiceServicer

    # more handler threads than batch_max, or the dispatcher could never
    # gather a full batch from concurrent clients
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max(workers, batch_max + 2)),
        interceptors=[TokenAuthInterceptor(access_token)]
        if access_token else [],
        options=[("grpc.max_send_message_length", 256 * 1024 * 1024),
                 ("grpc.max_receive_message_length", 256 * 1024 * 1024)])
    registration.add_all(
        server,
        generation=generation or GenerationServiceServicer(
            manager, batch_max=batch_max),
        engines=engines or EnginesServiceServicer(manager),
        dashboard=DashboardServiceServicer())
    bound = server.add_insecure_port(f"{host}:{port}")
    if not bound:
        raise RuntimeError(f"could not bind gRPC port {port}")
    server.start()
    return server, bound


def build_cache(args):
    """--cache_ram MB in memory (1 h TTL) before a disk cache under
    --cache_path: the router's /log images."""
    from .utils.cache import DiskCache, DualCache, MemoryLRUCache

    return DualCache(
        MemoryLRUCache(max_bytes=args.cache_ram * 1024 * 1024,
                       default_ttl=3600.0),
        DiskCache(args.cache_path) if args.cache_path else None)


@dataclass
class Serving:
    """The started servers of ``serve``."""

    generation: object
    grpc_server: object
    grpc_port: int
    http_server: object
    http_port: int

    def stop(self, grace: float = 2.0):
        self.http_server.shutdown()
        self.http_server.server_close()
        self.grpc_server.stop(grace).wait()


def serve(args, manager, cache=None, log_store=None) -> Serving:
    """Start the gRPC server and the HTTP router for ``manager`` on
    --grpc_port and --http_port (0: a free port), on localhost unless
    --listen_to_all, both behind --access_token when it is set; the
    servicers are shared, so an Async handle made over gRPC answers over
    HTTP too. ``cache`` (build_cache by default) holds the /log images and
    the artifact cache, ``log_store`` backs /log; url artifacts resolve
    through a ResourceProvider over --local_resource (and the network with
    --allow_network_resources)."""
    from .http.router import make_http_server, start_http_server
    from .services.engines import EnginesServiceServicer
    from .services.generate import GenerationServiceServicer
    from .utils.debug_recorder import DebugNullRecorder, DebugRecorder
    from .utils.resources import ResourceProvider

    cache = build_cache(args) if cache is None else cache
    local_roots = dict(item.partition("=")[::2]
                       for item in args.local_resources or [])
    manager.resources = ResourceProvider(
        cache, local_roots=local_roots,
        allow_network=args.allow_network_resources)
    recorder = (DebugRecorder(os.path.join(args.cache_path, "debug"))
                if args.debug_recording else DebugNullRecorder())
    generation = GenerationServiceServicer(
        manager, batch_max=manager.batch_max, debug_recorder=recorder,
        resource_cache=cache,
        nsfw_behaviour=getattr(args, "nsfw_behaviour", "flag"))
    engines = EnginesServiceServicer(manager)
    grpc_server, grpc_port = build_server(
        manager, args.grpc_port, batch_max=manager.batch_max,
        host="[::]" if args.listen_to_all else "localhost",
        workers=args.grpc_workers, generation=generation, engines=engines,
        access_token=args.access_token)
    http_server = make_http_server(
        "" if args.listen_to_all else "localhost", args.http_port,
        manager=manager, generation=generation, engines=engines,
        access_keys=[args.access_token] if args.access_token else None,
        image_cache=cache, log_store=log_store,
        proxies=dict(p.split("=", 1) for p in (args.proxies or [])),
        file_root=args.http_file_root or None)
    start_http_server(http_server)
    return Serving(generation, grpc_server, grpc_port, http_server,
                   http_server.server_address[1])


class SourceWatcher:
    """--reload: a polling watcher of the package's sources and the engine
    config that re-execs the server, as ``python -m gyre_tpu_torch.server``
    with the same ``argv``, when one changes."""

    def __init__(self, interval: float = 10.0, extra_paths=(), argv=()):
        self.interval = interval
        self.extra_paths = [p for p in extra_paths if p]
        self.argv = list(argv)
        self._mtimes: dict[str, float] = {}

    def _scan(self) -> dict[str, float]:
        import glob

        root = os.path.dirname(os.path.abspath(__file__))
        paths = glob.glob(os.path.join(root, "**", "*.py"), recursive=True)
        for extra in self.extra_paths:
            if os.path.isdir(extra):
                paths += glob.glob(os.path.join(extra, "**", "*.yaml"),
                                   recursive=True)
            elif os.path.exists(extra):
                paths.append(extra)
        out = {}
        for p in paths:
            try:
                out[p] = os.stat(p).st_mtime
            except OSError:
                pass
        return out

    def changed(self) -> list[str]:
        now = self._scan()
        if not self._mtimes:
            self._mtimes = now
            return []
        diff = [p for p, t in now.items()
                if self._mtimes.get(p) not in (None, t)]
        self._mtimes = now
        return diff

    def poll(self):
        """Re-exec the server if a watched file changed since the last
        scan. As a module, not by sys.argv[0]: run as a script, server.py
        would fail on its first relative import."""
        diff = self.changed()
        if diff:
            logger.info("source changed (%s); restarting",
                        os.path.basename(diff[0]))
            os.execv(sys.executable, [sys.executable, "-m", __spec__.name,
                                      *self.argv])

    def start(self):
        def watch():
            self.changed()  # baseline
            while True:
                time.sleep(self.interval)
                self.poll()

        threading.Thread(target=watch, daemon=True,
                         name="source-watcher").start()
        return self


def start_localtunnel(port: int, access_token: str):
    """--localtunnel: an ``npx localtunnel`` subprocess, its public URL
    logged from its output. Returns the Popen handle, or None without
    npx."""
    import re
    import shutil
    import subprocess

    npx = shutil.which("npx")
    if npx is None:
        logger.warning("localtunnel requested but npx is not installed")
        return None
    proc = subprocess.Popen(
        [npx, "--yes", "localtunnel", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def reader():
        for line in proc.stdout:  # type: ignore[union-attr]
            m = re.search(r"url is: https://(\S+)", line)
            if m:
                logger.info(
                    "localtunnel up: server '%s', port 443, key '%s'",
                    m.group(1), access_token)
            else:
                logger.info("localtunnel: %s", line.rstrip())

    threading.Thread(target=reader, daemon=True,
                     name="localtunnel").start()
    return proc


def start_prewarm(manager, mode: str, device_type: str):
    """--prewarm: the default engine's serving request on a background
    thread (auto = on with a CUDA device); returns the thread or None."""
    if mode == "auto":
        mode = "on" if device_type == "cuda" else "off"
    if mode not in ("on", "full"):
        return None

    def run():
        try:
            manager.prewarm(buckets=mode == "full")
        except Exception as e:  # noqa: BLE001 - a boundary: logged
            logger.warning("prewarm failed: %s", e)

    thread = threading.Thread(target=run, daemon=True, name="prewarm")
    thread.start()
    return thread


def main(argv=None, stop: threading.Event | None = None):
    """Run the server until ``stop`` is set; by default SIGINT and SIGTERM
    set it (when main runs on the main thread)."""
    import torch

    from .utils.logview import configure_logging
    from .utils.monitor import ResourceMonitor

    args = parse_args(argv)
    level = getattr(logging, args.log_level.upper(), logging.INFO)
    logging.basicConfig(level=level, format="%(asctime)s %(levelname)s "
                                            "%(name)s: %(message)s")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: start with --device cpu to run "
                         "on the CPU")
    if args.reload:
        SourceWatcher(extra_paths=[args.enginecfg],
                      argv=sys.argv[1:] if argv is None else argv).start()
    t0 = time.time()
    manager = build_manager(args)
    if args.nsfw_behaviour == "block" and manager.safety_checker() is None:
        # fail closed: blocking on random-weight flags would be noise
        logger.error("nsfw_behaviour=block requires trained safety-checker "
                     "weights; add a 'safety_checker:' model reference to "
                     "engines.yaml (e.g. CompVis/stable-diffusion-safety-"
                     "checker) or use --nsfw_behaviour flag/ignore")
        manager.dispatcher.stop()
        sys.exit(2)

    if args.save_safetensors:
        from .models.load import save_modelset

        engine_id, _, path = args.save_safetensors.partition(":")
        path = path or f"./{engine_id}-export"
        save_modelset(manager.modelset(engine_id), path)
        logger.info("exported %s -> %s", engine_id, path)
        manager.dispatcher.stop()
        return

    # the /log store and its image cache only on the serving path: an
    # export touches no cache directory
    cache = build_cache(args)
    log_store = configure_logging(level, image_cache=cache)
    serving = serve(args, manager, cache=cache, log_store=log_store)
    logger.info("gRPC on port %d, HTTP on port %d", serving.grpc_port,
                serving.http_port)
    tunnel = None
    try:
        if args.localtunnel:
            tunnel = start_localtunnel(serving.http_port, args.access_token)
        manager.load_engines()
        ResourceMonitor().log("engines loaded")
        logger.info("engines ready in %.1fs: %s", time.time() - t0,
                    ", ".join(manager.engine_ids))
        if str(args.batch_max) == "auto":
            eid = manager.default_engine_id()
            measured = manager.suggest_max_batch(eid)
            manager.batch_max = measured
            manager.dispatcher.max_batch = max(measured, 1)
            serving.generation.batch_max = measured
            logger.info("batch_max auto: measured %d for %s", measured, eid)
        start_prewarm(manager, args.prewarm, device.type)

        if stop is None:
            stop = threading.Event()
            if threading.current_thread() is threading.main_thread():
                signal.signal(signal.SIGTERM, lambda *_: stop.set())
                signal.signal(signal.SIGINT, lambda *_: stop.set())
        stop.wait()
    finally:
        logger.info("shutting down")
        if tunnel is not None:
            tunnel.terminate()
            tunnel.wait(timeout=10)
        serving.stop()
        manager.dispatcher.stop()


if __name__ == "__main__":
    main()
