"""The benchmark measures the port alone: nothing it runs imports JAX, the
reference package or the repository's older benchmarks, and its plain
references import nothing of the program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_the_reference_package_or_benchmarks(path):
    bad = {"benchmarks", *FORBIDDEN}
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & bad, f"{path} imports {sorted(tops & bad)}"
    if path.parent.name == "reference":
        assert "repro_torch" not in tops, f"{path} imports the program"


def test_forbidden_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.core.client", "jaxtyping", "torch"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["repro.core", "jax._src"]) == [
        "jax", "repro"]


def test_a_whole_run_loads_none_of_them():
    """A tiny cell served, traced and checked in a fresh process: its
    sys.modules holds no jax, jaxlib, flax or repro afterwards."""
    code = (
        "import json, sys, time\n"
        "from portbench.tests.tiny import tiny_cell, DENSE\n"
        "from portbench.run import run_cell, result, forbidden_modules\n"
        "cell = tiny_cell(DENSE, 'rag')\n"
        "rec = run_cell(cell, 3, 0.3, True, 'cpu', time.perf_counter(),\n"
        "               warm_s=0)\n"
        "result(cell, rec, True); result(cell, rec, False)\n"
        "print(json.dumps(forbidden_modules()))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
