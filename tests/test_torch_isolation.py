"""The port imports neither JAX nor the JAX package.

In a fresh interpreter, import every module of ``repro_torch`` and
``chip_smoke.py`` and check ``sys.modules`` afterwards.
"""
import json
import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {repo!r})
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(json.dumps({{"imported": mods, "bad": bad}}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=SRC, repo=REPO)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    expected = {m.name for m in pkgutil.walk_packages(
        [os.path.join(SRC, "repro_torch")], "repro_torch.")}
    assert set(res["imported"]) == expected
    assert "repro_torch.kernels.ops" in expected
    assert "repro_torch.launch.search" in expected
    assert "repro_torch.serving.search_service" in expected
    assert "repro_torch.launch.serve_search" in expected
