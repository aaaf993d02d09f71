"""gRPC server of the PyTorch/CUDA port.

    python -m gyre_tpu_torch.server [--enginecfg engines.yaml]
        [--grpc_port 50051] [--batch_max 4] [--device cuda]

Serves gooseai.GenerationService (Generate, txt2img) and
gooseai.EnginesService (ListEngines) on one device. --enginecfg names a
YAML list of engine entries (``model: {preset: sd15, seed: 0}``); without
it the server runs one random-weight ``sd15`` engine. --device defaults to
cuda and refuses to start without a CUDA device; --device cpu runs the
same path on the CPU (for tests at small presets).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading
from concurrent import futures

logger = logging.getLogger("gyre_tpu_torch")

DEFAULT_ENGINES = [{"id": "sd15", "name": "Stable Diffusion 1.5 (random "
                    "weights)", "default": True,
                    "model": {"preset": "sd15", "seed": 0}}]


def parse_args(argv=None):
    p = argparse.ArgumentParser("gyre_tpu_torch server")
    p.add_argument("--enginecfg", type=str,
                   default=os.environ.get("SD_ENGINECFG") or None,
                   help="YAML list of engine entries (default: one "
                        "random-weight sd15 engine)")
    p.add_argument("--grpc_port", type=int,
                   default=int(os.environ.get("SD_GRPC_PORT", 50051)))
    p.add_argument("--batch_max", type=int,
                   default=int(os.environ.get("SD_BATCH_MAX", 4)),
                   help="max rows the dispatcher merges into one batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the engines run on")
    return p.parse_args(argv)


# gRPC handler threads: more than batch_max, or the dispatcher could never
# gather a full batch from concurrent clients
GRPC_WORKERS = 16


def build_server(manager, port: int, batch_max: int = 4,
                 host: str = "[::]"):
    """A started grpc.Server serving ``manager``; returns (server, port)."""
    import grpc

    from gyre_tpu.services import registration

    from .services.engines import EnginesServiceServicer
    from .services.generate import GenerationServiceServicer

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=GRPC_WORKERS))
    registration.add_all(
        server,
        generation=GenerationServiceServicer(manager, batch_max=batch_max),
        engines=EnginesServiceServicer(manager))
    bound = server.add_insecure_port(f"{host}:{port}")
    if not bound:
        raise RuntimeError(f"could not bind gRPC port {port}")
    server.start()
    return server, bound


def main(argv=None):
    import torch

    from .manager.manager import EngineManager, load_yaml

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: start with --device cpu to run "
                         "on the CPU")
    entries = load_yaml(args.enginecfg) if args.enginecfg \
        else DEFAULT_ENGINES
    manager = EngineManager(entries, device=device,
                            batch_max=args.batch_max)
    manager.load_engines()
    server, port = build_server(manager, args.grpc_port,
                                batch_max=args.batch_max)
    logger.info("engines ready; gRPC on port %d", port)
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
