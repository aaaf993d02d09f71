"""A configuration's model family, found by name as files, the way metrics
are (``harness.reader``). A configuration names its family under
``"family"``; the family is two files:

* ``families/<family>.py``: ``layout(config)``, the weights' published
  keys, shapes and draws; ``request(config, images, height, width,
  steps)`` and ``chunk_work(config, chunk)``, the model work as
  ``flops.Work``; ``serve(config, state, device, dtype, engine_id)``, the
  port's ModelSet built from the benchmark's weights;
* ``reference/<family>.py``: ``Reference(config, state, quant=None)`` with
  ``generate(requests, device)``, and ``fp8_quant``, the control's
  rounding.

Both are read from the benchmark directory the configuration was read
from (``harness.cell_files`` records it under ``"benchmark_dir"``), this
one where it records none.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


@functools.cache
def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(config: dict, kind: str):
    fam = config["family"]
    path = Path(config.get("benchmark_dir", HERE)) / kind / f"{fam}.py"
    name = f"benchmark_{kind}_{fam.replace('.', '_').replace('-', '_')}"
    return _load(str(path), name)


def code(config: dict):
    """``families/<family>.py`` of the configuration."""
    return _module(config, "families")


def reference(config: dict):
    """``reference/<family>.py`` of the configuration."""
    return _module(config, "reference")
