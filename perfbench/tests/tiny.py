"""A copy of the benchmark with tiny cells that a CPU test run can hold.

``checkout(tmp)`` copies ``BENCHMARK.json`` and ``perfbench/`` into
``tmp``, links the program's ``src``, and adds a mix and a cell on
``resnet50.cloud`` (feasible from the first epoch, so every search has an
answer to judge): ``tiny.two_stage`` (4 epochs, then 40 GA
generations).  Each per-layer metric of the full-size cell is listed for
its tiny counterpart too.
"""
from __future__ import annotations

import io
import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "tiny_two_stage": ("two_stage", {
        "eps": 4,
        "options": {"episodes_per_epoch": 1,
                    "ga": {"population": 20, "generations": 40}},
        "warmup": {"eps": 2, "env": {"platform": "unlimited"},
                   "options": {"ga": {"generations": 2}}},
        "trace": {"progress_every": 2, "slices": [
            {"phase": "stage1", "engine": "reinforce", "start_after": 1,
             "callbacks": 1, "steps": 2},
            {"phase": "stage2", "engine": "local_ga", "start_after": 3,
             "callbacks": 2, "steps": 2}]}}),
}
CELLS = {"tiny.two_stage": ("tiny_two_stage", "resnet50.two_stage")}


def checkout(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / "src", root / "src")
    for name, (base, over) in TINY.items():
        mix = json.loads((REPO / "perfbench" / "traffic"
                          / f"{base}.json").read_text())
        mix.update(over, name=name)
        (root / "perfbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, (mix, like) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": "resnet50.cloud",
                                   "traffic": mix, "chips": 1, "why": like})
        for m in bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, cell: str, seed: int = 5_000_000_123,
        traced: bool = False):
    """One CPU run of ``cell``: (result, what it wrote to stderr)."""
    from perfbench import harness

    log = io.StringIO()
    result = harness.run_cell(root, cell, seed, 0.0, traced, "cpu",
                              log=log)
    return result, log.getvalue()
