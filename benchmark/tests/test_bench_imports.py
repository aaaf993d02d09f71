"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names (the part before the first dot) compared whole, so the port,
whose name begins with the JAX package's, passes."""

import ast
import subprocess
import sys
import types
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    """Every source the harness may load, the families' and references'
    files found by name with them."""
    sources = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert {p.parent.name for p in sources} >= {"families", "reference",
                                                "metrics"}
    for path in sources:
        assert not _imported_tops(path) & set(harness.JAX_MODULES), path


def test_jax_check_compares_whole_names(monkeypatch):
    import gyre_tpu_torch.models.configs  # noqa: F401

    assert harness.jax_loaded() == []
    monkeypatch.setitem(sys.modules, "gyre_tpu.utils",
                        types.ModuleType("gyre_tpu.utils"))
    assert harness.jax_loaded() == ["gyre_tpu"]


def test_a_run_loads_no_jax():
    """Everything a run imports, the port's serving path with it, in a
    fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import family, harness, program, trace, flops\n"
        "from benchmark import traffic\n"
        "from benchmark.reference import sd\n"
        "import gyre_tpu_torch.server, gyre_tpu_torch.manager.manager\n"
        "import gyre_tpu_torch.services.generate, gyre_tpu_torch.models.load\n"
        "import gyre_tpu_torch.models.modelset\n"
        "import gyre_tpu_torch.pipeline.schedule\n"
        "import gyre_tpu_torch.pipeline.tokenizer\n"
        "man = harness.load_json(harness.HERE.parent / 'BENCHMARK.json')\n"
        "for w in man['workloads']:\n"
        "    cfg = harness.cell_files(man, w['name'])['config']\n"
        "    family.code(cfg), family.reference(cfg)\n"
        "for m in ('images_per_s', 'mfu', 'k1_roofline', 'k2b_roofline'):\n"
        "    harness.reader(m)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'gyre_tpu'}))\n"
        "print('gyre_tpu_torch' in tops)\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == ["[]", "True"]
