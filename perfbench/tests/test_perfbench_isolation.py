"""What the benchmark loads: never JAX or the JAX package, and the plain
references nothing of the program.  Top-level module names are compared
whole (``repro_torch`` is not ``repro``)."""
import ast
import json
import os
import subprocess
import sys

from perfbench.tests.tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}

_RUN = r"""
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from perfbench.tests import tiny
from perfbench import harness
import importlib, pkgutil, perfbench
for m in pkgutil.walk_packages(perfbench.__path__, "perfbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
root = tiny.checkout({tmp!r})
tiny.run(root, "tiny.two_stage", traced=True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF = r"""
import json, sys
sys.path.insert(0, {repo!r})
import perfbench.reference.costmodel, perfbench.reference.policy
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_levels(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_traced_run_loads_no_jax_and_no_jax_package(tmp_path):
    loaded = _top_levels(_RUN.format(repo=str(REPO), tmp=str(tmp_path)))
    assert "repro_torch" in loaded and "perfbench" in loaded
    assert not loaded & FORBIDDEN


def test_the_references_load_nothing_of_the_program():
    loaded = _top_levels(_REF.format(repo=str(REPO)))
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    bad = []
    for path in (REPO / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                ref = "reference" in path.parts
                if top in FORBIDDEN or (ref and top == "repro_torch"):
                    bad.append(f"{path.relative_to(REPO)}: {n}")
    assert not bad
