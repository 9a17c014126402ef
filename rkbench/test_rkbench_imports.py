"""Nothing the benchmark runs loads JAX or the JAX package `repro`, and the
reference imports nothing of the program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

# a fresh interpreter: the test workers have imported JAX for other files
_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
torch.set_num_threads(2)
import rkbench
from rkbench import manifest, harness
from rkbench.conftest import tiny
for mod in pkgutil.walk_packages(rkbench.__path__, "rkbench."):
    importlib.import_module(mod.name)
man = manifest.load_manifest()
for m in man["per_layer"]:
    manifest.metric_reader(m["name"])
for cell in man["workloads"]:
    m_, c_, cfg, traffic = tiny(cell["name"])
    manifest.reference(cfg["reference"])
    manifest.loop(traffic["loop"])
    import time
    res = harness.run(m_, c_, cfg, traffic, 2**31 + 11, 0.2, True,
                      time.perf_counter(), "cpu", log=lambda o: None)
    assert res["correct"], res["checks"]
import repro_torch.core.engine, repro_torch.kernels.ops
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def test_a_run_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "rkbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((HERE / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "math", "numpy", "torch"}


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_of_the_benchmark_imports_jax(path):
    assert not _imports(path) & FORBIDDEN
