"""gRPC server of the PyTorch/CUDA port.

    python -m gyre_tpu_torch.server [--enginecfg config/engines.yaml]
        [--weight_root DIR] [--engine_id ID] [--device cuda] ...

Serves gooseai.GenerationService (Generate, txt2img) and
gooseai.EnginesService (ListEngines) on one device. The generation and
weight flags are the JAX server's (gyre_tpu/server.py), with its names,
``SD_*`` environment variables and defaults: --enginecfg names an
engines.yaml in the DSL (default ``config/engines.yaml``; one random-weight
SD 1.5 engine when the file is missing), --weight_root the directories
model references resolve in, --save_safetensors ENGINE_ID:PATH exports an
engine and exits. --device defaults to cuda and refuses to start without a
CUDA device; --device cpu runs the same path on the CPU (for tests at
small presets). The HTTP/REST router, access tokens, proxies and the NSFW,
resource and debug flags are not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading
import time
from concurrent import futures

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
    gen.add_argument("--save_safetensors", type=str, default=None,
                     metavar="ENGINE_ID:PATH",
                     help="export an engine's weights as a diffusers-layout "
                          "safetensors directory and exit")

    dev = p.add_argument_group("device")
    dev.add_argument("--device", type=str, default="cuda",
                     help="torch device the engines run on")
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
                     help="weight downloads go to <cache_path>/weights")
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
    dbg.add_argument("--log_level", type=str,
                     default=os.environ.get("SD_LOG_LEVEL", "INFO"))
    return p.parse_args(argv)


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


def build_manager(args):
    """The EngineManager of parsed arguments: engine entries from
    --enginecfg (with the hbm/vram include flags of -V), filtered by
    --engine_id, on --device in --dtype, weights resolved under
    --weight_root."""
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
    return EngineManager(entries, device=args.device, compute_dtype=dtype,
                         batch_max=batch_max, weight_resolver=resolver,
                         interleave=int(args.interleave),
                         gather_ms=float(args.gather_ms),
                         watchdog_s=float(args.watchdog))


def build_server(manager, port: int, batch_max: int = 4,
                 host: str = "[::]", workers: int = 16):
    """A started grpc.Server serving ``manager``; returns (server, port)."""
    import grpc

    from .services import registration
    from .services.engines import EnginesServiceServicer
    from .services.generate import GenerationServiceServicer

    # more handler threads than batch_max, or the dispatcher could never
    # gather a full batch from concurrent clients
    server = grpc.server(futures.ThreadPoolExecutor(
        max_workers=max(workers, batch_max + 2)))
    registration.add_all(
        server,
        generation=GenerationServiceServicer(manager, batch_max=batch_max),
        engines=EnginesServiceServicer(manager))
    bound = server.add_insecure_port(f"{host}:{port}")
    if not bound:
        raise RuntimeError(f"could not bind gRPC port {port}")
    server.start()
    return server, bound


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


def main(argv=None):
    import torch

    from .utils.monitor import ResourceMonitor

    args = parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(),
                                      logging.INFO),
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: start with --device cpu to run "
                         "on the CPU")
    t0 = time.time()
    manager = build_manager(args)

    if args.save_safetensors:
        from .models.load import save_modelset

        engine_id, _, path = args.save_safetensors.partition(":")
        path = path or f"./{engine_id}-export"
        save_modelset(manager.modelset(engine_id), path)
        logger.info("exported %s -> %s", engine_id, path)
        manager.dispatcher.stop()
        return

    manager.load_engines()
    ResourceMonitor().log("engines loaded")
    logger.info("engines ready in %.1fs: %s", time.time() - t0,
                ", ".join(manager.engine_ids))
    if str(args.batch_max) == "auto":
        eid = manager.default_engine_id()
        measured = manager.suggest_max_batch(eid)
        manager.batch_max = measured
        manager.dispatcher.max_batch = max(measured, 1)
        logger.info("batch_max auto: measured %d for %s", measured, eid)
    server, port = build_server(manager, args.grpc_port,
                                batch_max=manager.batch_max,
                                workers=args.grpc_workers)
    logger.info("gRPC on port %d", port)
    start_prewarm(manager, args.prewarm, device.type)

    done = threading.Event()

    def shutdown(*_):
        done.set()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    done.wait()
    server.stop(grace=5).wait()
    manager.dispatcher.stop()


if __name__ == "__main__":
    main()
