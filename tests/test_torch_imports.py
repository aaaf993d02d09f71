"""The port, chip_smoke.py and kernel_sweep.py import nothing of JAX,
nothing of the JAX package gyre_tpu and not OpenCV (the card's machine
has none), and chip_smoke.py refuses to run without a CUDA device (no CPU
continuation)."""

import ast
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["gyre_tpu"] = None     # and so does any import of the JAX package
sys.modules["cv2"] = None          # and of OpenCV
import gyre_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gyre_tpu_torch.__path__,
                                               "gyre_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("manager.engines_yaml", "manager.weights", "manager.mixing",
             "models.load", "models.ldm", "utils.monitor", "http",
             "http.grpc_web", "http.grpc_web_client", "http.router",
             "http.stability_rest", "services.dashboard", "utils.cache",
             "utils.resources", "utils.logview", "utils.debug_recorder",
             "ops.resize", "ops.images", "pipeline.modes", "models.vae",
             "pipeline.lora", "manager.hints", "models.controlnet",
             "models.t2i_adapter", "services.adjustments", "models.dpt",
             "models.zoedepth", "pipeline.clip_guidance",
             "utils.latent_debug", "models.hinters", "models.pose",
             "models.uniformer", "models.baenormal", "models.mlsd",
             "models.swinir", "models.hat", "models.esrgan",
             "models.inspyrenet", "pipeline.upscaler", "models.kunet",
             "models.codeformer", "ops.tome",
             "pipeline.diffusion_upscaler", "pipeline.safety", "models.clip",
             "parallel", "parallel.mesh", "parallel.pool"):
    assert "gyre_tpu_torch." + name in names, name
import chip_smoke, kernel_sweep  # the root scripts
loaded = [k for k, v in sys.modules.items()
          if v is not None and k.split(".")[0] in ("jax", "jaxlib", "gyre_tpu",
                                                   "cv2")]
assert not loaded, loaded
print(len(names))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO if cwd == REPO else "")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 75      # every module imported


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py itself imports neither jax nor the JAX package."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    roots = {name.split(".")[0] for name in names}
    assert not roots & {"jax", "jaxlib", "gyre_tpu", "cv2"}, roots


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """Here there is no CUDA device; alone in a directory it also lacks the
    port. Either way: non-zero exit and no result line."""
    runs = [_run([os.path.join(REPO, "chip_smoke.py")], REPO)]
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    runs.append(_run(["chip_smoke.py"], str(tmp_path)))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
