"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Each ``csrc/*.cu`` file is compiled by nvcc for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/gyre_tpu_torch/`` at
the root of the checkout. A library is named after the hash of its source
and flags, so a changed source rebuilds and an unchanged one loads at once.
The files compile in parallel. A build or load failure raises: nothing
switches to the plain PyTorch versions.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.

``launches`` counts kernel launches by name: every wrapper adds one where it
launches its kernel, and nowhere else, so a run can show which kernels its
path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gyre_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points, by source file
SIGNATURES = {
    "flash_attention": {
        "gyre_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 *[_L] * 12, _F, _P]},
    "gn_stats": {
        "gyre_gn_stats": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                          _P]},
    "gn_silu_conv3x3": {
        "gyre_gn_silu_conv3x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _P]},
}

launches = {name: 0 for name in ("flash_attention", "gn_stats",
                                 "gn_silu_conv3x3")}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches():
    for name in launches:
        launches[name] = 0


def nvcc() -> str:
    """The nvcc under CUDA_HOME (default /usr/local/cuda), else on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of gyre_tpu_torch are built at first use")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every kernel library that is missing; returns name -> path.
    ptxas's report (registers, shared memory, spills) is kept beside each
    library as ``<library>.log``."""
    targets = {name: _target(name) for name in SIGNATURES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        procs = {}
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            target = todo[name]
            target.with_suffix(".so.log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                              f"{out}")
                continue
            os.replace(tmp, target)   # atomic against concurrent builds
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if not _libs:
            for n, path in build().items():
                cdll = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[n].items():
                    getattr(cdll, fn).argtypes = argtypes
                    getattr(cdll, fn).restype = ctypes.c_int
                _libs[n] = cdll
    return _libs[name]


def require(t, name: str, dtype, shape=None):
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` (and ``shape``): what every kernel's C entry point assumes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def check(rc: int, name: str):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
