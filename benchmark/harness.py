"""One run of one cell: set-up, the measured window of closed-loop gRPC
clients, the trace, the check against the plain reference, and the result
line.

Everything a cell is made of is found by name, as files: the cell under
``workloads/``, its configuration under ``configs/`` and its model family's
code under ``families/`` and ``reference/`` (``family.py``), its traffic
mix under ``traffic/``, and each metric's reader under ``metrics/``
(``read(run)`` returns a number, or None when it finds nothing to
read). Which metrics a run reports comes from BENCHMARK.json: the
end-to-end ones without ``--trace``, the per-layer ones with it, each in
the cells its ``workloads`` key names (every cell where it has none).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
JAX_MODULES = ("jax", "jaxlib", "flax", "gyre_tpu")


class RunError(RuntimeError):
    """A run that cannot print a result."""


# ------------------------------------------------------------------ files


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_files(manifest: dict, name: str, data: Path = HERE) -> dict:
    """The cell's manifest entry, workload, configuration and traffic.
    The configuration must name its family; it records the directory it
    was read from, where its family's files are found (``family.py``)."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(data / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"],
                                                     entry["traffic"]):
        raise RunError(f"workloads/{name}.json disagrees with BENCHMARK.json")
    config = load_json(data / "configs" / f"{entry['config']}.json")
    if not config.get("family"):
        raise RunError(f"configs/{entry['config']}.json names no family: "
                       "its \"family\" key finds families/<family>.py and "
                       "reference/<family>.py")
    config["benchmark_dir"] = str(data)
    mix = load_json(data / "traffic" / f"{entry['traffic']}.json")
    if mix.get("loop") != "closed":
        raise RunError(f"traffic/{entry['traffic']}.json: loop "
                       f"{mix.get('loop')!r}; the harness drives closed-loop "
                       "clients only")
    mix["words_path"] = str(data / "traffic" / mix["words"])
    return {"entry": entry, "workload": workload, "config": config,
            "mix": mix}


def metric_names(manifest: dict, cell: str, trace: bool) -> list[dict]:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if cell in m.get("workloads", [cell])]


def reader(name: str, metrics_dir: Path = HERE / "metrics"):
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def devices(chips: int):
    """The card's name, or RunError when fewer CUDA devices than the cell
    asks for are visible. Never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} visible")
    return torch.cuda.get_device_name(0)


def jax_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(JAX_MODULES))


# ----------------------------------------------------------------- the run


class Run:
    """What one run measured; the metric readers read it."""

    def __init__(self, cell: dict, seed: int, seconds: float):
        self.cell = cell
        self.config, self.mix = cell["config"], cell["mix"]
        self.workload = cell["workload"]
        self.seed, self.seconds = seed, seconds
        self.setup_s = 0.0
        self.t0 = self.t_end = 0.0
        self.records: list[dict] = []
        self.stats: dict = {}
        self.dispatched: list = []
        self.chunks: list = []
        self.trace = None
        self.peak_bytes = 0
        self.check: dict = {}
        self.notes: dict = {}

    def latencies(self) -> list[float]:
        return [r["t_done"] - r["t_send"] for r in self.records if r["ok"]]


def _clients(system, run: Run, port: int, tracer=None, traced_at=None):
    """The closed-loop window: every client sends its next request when the
    previous one's last answer has arrived, until the window closes; the
    requests in flight then are waited for."""
    from . import program, traffic

    per_client = traffic.client_requests(run.mix, run.seed)
    stubs = [program.client_stub(port) for _ in per_client]
    for _, _, list_engines in stubs:          # connections up before t0
        list_engines()
    box: dict = {}

    def opened():
        box["t0"] = time.perf_counter()

    barrier = threading.Barrier(len(per_client) + 1, action=opened)
    lock = threading.Lock()

    def client(ci: int):
        _, generate, _ = stubs[ci]
        reqs = per_client[ci]
        barrier.wait()
        t_end = box["t0"] + run.seconds
        i = 0
        while time.perf_counter() < t_end:
            req = reqs[i % len(reqs)]
            proto = program.request_proto(req, system.engine_id,
                                          f"c{ci}-{i}")
            rec = {"client": ci, "i": i, "req": req,
                   "t_send": time.perf_counter()}
            try:
                rec["images"] = program.image_bytes(
                    generate(proto, timeout=900))
                rec["ok"] = len(rec["images"]) == 1
                rec["error"] = None if rec["ok"] else "no image"
            except Exception as e:  # noqa: BLE001 - counted as failed
                rec.update(images=[], ok=False, error=repr(e)[:300])
            rec["t_done"] = time.perf_counter()
            with lock:
                run.records.append(rec)
            i += 1

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(len(per_client))]
    for t in threads:
        t.start()
    n0 = len(system.dispatcher.dispatched)
    pauses, began = [], {}

    def gc_pause(phase, info):
        if phase == "start":
            began["t"] = time.perf_counter()
        elif "t" in began:
            pauses.append((info["generation"],
                           time.perf_counter() - began.pop("t")))

    gc.callbacks.append(gc_pause)
    cpu0 = os.times()
    barrier.wait()
    run.t0 = box["t0"]
    run.t_end = run.t0 + run.seconds
    if tracer is not None:
        time.sleep(max(run.t0 + traced_at[0] - time.perf_counter(), 0.0))
        tracer.start()
        time.sleep(max(run.t0 + traced_at[1] - time.perf_counter(), 0.0))
        tracer.stop()
    time.sleep(max(run.t_end - time.perf_counter(), 0.0))
    gc.callbacks.remove(gc_pause)
    cpu1 = os.times()
    run.notes["process_cpu_s_in_window"] = (cpu1.user - cpu0.user +
                                            cpu1.system - cpu0.system)
    run.notes["gc_in_window"] = {
        f"gen{g}": [sum(1 for x, _ in pauses if x == g),
                    sum(d for x, d in pauses if x == g),
                    max([d for x, d in pauses if x == g], default=0.0)]
        for g in (0, 1, 2)}
    run.stats = system.stats()
    run.dispatched = list(system.dispatcher.dispatched[n0:])
    if tracer is not None:
        # the two profiler jobs are dispatched as 1-row solo batches
        for _ in range(2):
            run.dispatched.remove((1, 1))
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        raise RunError("a request never came back")
    for channel, _, _ in stubs:
        channel.close()
    run.chunks = list(system.log.entries)


def measure(cell: dict, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda") -> Run:
    """Set-up, window, trace: everything but the check."""
    import torch

    from . import program, traffic, weights

    run = Run(cell, seed, seconds)
    cfg, mix, wl = cell["config"], cell["mix"], cell["workload"]
    marks = [("start", t_start), ("imports", time.perf_counter())]
    state = weights.make(cfg, seed, device,
                         getattr(torch, cfg["serving"]["dtype"]))
    run.check["weights_sum"] = _checksum(state)
    marks.append(("weights", time.perf_counter()))
    system = program.System(cfg, wl, state, device, cell["entry"]["config"])
    del state
    gc.collect()
    marks.append(("program_load", time.perf_counter()))
    try:
        # the shapes this run's requests use, and no others
        for h, w, steps in sorted({
                (r["height"], r["width"], r["steps"])
                for c in traffic.client_requests(mix, seed) for r in c}):
            system.prewarm(h, w, steps)
        marks.append(("prewarm", time.perf_counter()))
        port = system.start(workers=int(mix["clients"]) + 4)
        tracer = t_trace = None
        if trace:
            from .trace import Tracer

            tracer = Tracer(system)
            tracer.prime()
            t_trace = (seconds * wl["trace"]["start"],
                       seconds * wl["trace"]["stop"])
        # set-up's garbage collected before the window, so that no full
        # collection of it (0.23-0.27 s with the GIL held) falls inside
        gc.collect()
        _clients(system, run, port, tracer, t_trace)
        run.setup_s = run.t0 - t_start
        marks.append(("server_and_clients", run.t0))
        run.notes["setup_phases_s"] = {
            b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
        if device != "cpu":
            torch.cuda.synchronize()
            run.peak_bytes = torch.cuda.max_memory_allocated()
        if tracer is not None:
            t = time.perf_counter()
            run.trace = tracer.reduce()
            tracer.prof = None
            run.notes["trace_reduce_s"] = time.perf_counter() - t
    finally:
        system.close()
        del system
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    return run


def _checksum(state: dict) -> float:
    """A cheap fingerprint of the weights, to show that the reference's
    regenerated weights are the program's."""
    return float(sum(float(t.float().sum()) for k, t in sorted(state.items())
                     if k.endswith("conv_out.weight") or
                     k.endswith("token_embedding.weight")))


# --------------------------------------------------------------- the check


def image_gaps(got: np.ndarray, want: np.ndarray) -> tuple[float, int]:
    """(mean, largest) absolute difference in levels of one HxWx3 uint8
    image against the reference's; a wrong shape reads 255."""
    if got.shape != want.shape:
        return 255.0, 255
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return float(d.mean()), int(d.max())


def judge(means: list, maxes: list, limits: dict, failed: int = 0,
          same: bool = True) -> tuple[dict, bool]:
    """The numbers compared, each beside its limit, and whether they make
    the run correct: the worst image's mean and largest gap within the
    cell's limits, no failed request, the reference's weights the
    program's."""
    out = {"image_mean_gap": {"value": max(means) if means else None,
                              "limit": limits["image_mean_gap"]},
           "image_max_gap": {"value": max(maxes) if maxes else None,
                             "limit": limits["image_max_gap"]},
           "failed_requests": {"value": failed, "limit": 0},
           "weights_regenerated_equal": {"value": int(same), "limit": 1}}
    correct = bool(means and same and failed == 0 and
                   max(means) <= limits["image_mean_gap"] and
                   max(maxes) <= limits["image_max_gap"])
    return out, correct


def check(run: Run, device: str = "cuda") -> dict:
    """Compare the PNGs the clients received, a sample drawn from the seed,
    with the plain float32 reference's images of the same requests.
    Returns {name: {"value", "limit"}} and sets run.check["correct"]."""
    import torch

    from . import family, png, weights

    spec = run.workload["check"]
    done = [r for r in run.records if r["ok"]]
    rng = np.random.default_rng([int(run.seed), 0x636865636B])
    k = min(int(spec["sample"]), len(done))
    pick = sorted(rng.choice(len(done), k, replace=False).tolist())
    sample = [done[i] for i in pick]
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    state = weights.make(run.config, run.seed, device,
                         getattr(torch, run.config["serving"]["dtype"]))
    same = _checksum(state) == run.check["weights_sum"]
    ref = family.reference(run.config).Reference(run.config, state)
    means, maxes = [], []
    block = int(spec.get("block", 1))
    for b in range(0, len(sample), block):
        part = sample[b:b + block]
        want = ref.generate([r["req"] for r in part], device)
        for r, w in zip(part, want):
            mean, most = image_gaps(png.pixels(r["images"][0])[..., :3], w)
            means.append(mean)
            maxes.append(most)
    del ref, state
    gc.collect()
    failed = sum(1 for r in run.records if not r["ok"])
    out, run.check["correct"] = judge(means, maxes, spec["limits"], failed,
                                      same)
    run.check["images"] = {"mean": means, "max": maxes}
    return out


# -------------------------------------------------------------- the result


def metrics(run: Run, manifest: dict, trace: bool) -> dict:
    out = {}
    for m in metric_names(manifest, run.cell["entry"]["name"], trace):
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(args, root: Path, t_start: float, out=sys.stdout,
         err=sys.stderr) -> int:
    manifest = load_json(root / "BENCHMARK.json")
    cell = cell_files(manifest, args.workload)
    try:
        kind = devices(int(cell["entry"]["chips"]))
    except RunError as e:
        print(f"benchmark: {e}", file=err)
        return 3
    # transformers, where the port loads it, would import Flax (and JAX)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    cached = any((root / "build" / "gyre_tpu_torch").glob("*.so"))
    run = measure(cell, args.seed, float(args.seconds), bool(args.trace),
                  t_start)
    run.notes["kernels_cached_at_start"] = cached
    result_metrics = metrics(run, manifest, bool(args.trace))
    t_check = time.perf_counter()
    compared = check(run)
    run.notes["check_s"] = time.perf_counter() - t_check
    found = jax_loaded()
    if found:
        print(f"benchmark: JAX modules loaded in the run's process: {found}",
              file=err)
        return 4
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": int(run.peak_bytes)}
    line = {"correct": run.check["correct"],
            "attempted": len(run.records),
            "failed": sum(1 for r in run.records if not r["ok"]),
            "metrics": result_metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["check"] = compared
    tail = sorted(((r["t_done"] - r["t_send"], r["t_send"] - run.t0)
                   for r in run.records if r["ok"]), reverse=True)[:16]
    run.notes["slowest_requests_latency_and_send_s"] = tail
    print(json.dumps({"power_limit": _power_limit(),
                      "images_mean_gap": run.check["images"]["mean"],
                      "images_max_gap": run.check["images"]["max"],
                      "setup_s": run.setup_s, "notes": run.notes,
                      "torch": torch.__version__}), file=err)
    for name, c in compared.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    print(json.dumps(line), file=out)
    out.flush()
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
