"""One run of one cell: set-up, the measured window, the traced slice, the
metrics and the judgement of every search the run made.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``'s ``workloads``, its configuration at the ``file`` its
``configs`` entry names, its traffic mix at ``perfbench/traffic/<name>.json``
and each metric's reader at ``perfbench/metrics/<name>.py``.  A reader is a
module with ``read(run) -> float | None`` (:class:`RunData` is what it
reads); it returns None where the run holds nothing for it to read, and the
metric is then left out of the result.

The program is reached through its public entry
(``repro_torch.api.run_search``), its telemetry (``repro_torch.obs``: the
``search.run`` and ``search.chunk`` spans) and ``torch.profiler``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from perfbench import check
from perfbench import trace as trace_lib
from perfbench import traffic as traffic_lib

# Top-level modules a run of the port must not have loaded.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: Path, name: str) -> Cell:
    """The cell ``name`` of the checkout at ``root``, with its files."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(root / "perfbench" / "traffic"
                          / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(root: Path, metric: str):
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    searches: int                     # whole searches in the window
    spans: list                       # the window's obs spans (traced run)
    slices: list                      # trace.Slice of the traced search

    def search_spans(self, method: Optional[str] = None):
        """[(search.run span, [its search.chunk spans])] of the window, of
        the given method only if one is named."""
        runs = [s for s in self.spans if s["name"] == "search.run"
                and (method is None
                     or s.get("attrs", {}).get("method") == method)]
        out = []
        for r in runs:
            lo, hi = r["ts_us"], r["ts_us"] + r["dur_us"]
            out.append((r, [c for c in self.spans
                            if c["name"] == "search.chunk"
                            and c["tid"] == r["tid"]
                            and lo <= c["ts_us"]
                            and c["ts_us"] + c["dur_us"] <= hi]))
        return out


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts, from ``nvidia-smi``."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(p.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(root: Path, name: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda",
             t0: Optional[float] = None, log=sys.stderr) -> dict:
    """One run of cell ``name``; returns the result object.  ``t0`` is the
    host clock at the process's start (set-up is counted from it)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = resolve(root, name)
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    from repro_torch import api, obs

    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    t_import = time.perf_counter() - t0

    def request(seed_k, warmup=False, **extra):
        return traffic_lib.request(api, cfg, mix, seed_k, device,
                                   warmup=warmup, **extra)

    # Set-up: import, the card, the kernels' libraries (built on the
    # first run in a checkout), and a search at the cell's own shapes.
    api.run_search(request(traffic_lib.warmup_seed(seed), warmup=True))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    if traced:
        obs.enable(trace=True)
        obs.reset()
    runs, walls = [], []
    w0 = time.perf_counter()
    while not runs or time.perf_counter() - w0 < seconds:
        req = request(traffic_lib.search_seed(seed, len(runs)))
        t = time.perf_counter()
        runs.append((req, api.run_search(req)))
        walls.append(time.perf_counter() - t)
    window_s = time.perf_counter() - w0
    spans = obs.tracer().spans() if traced else []
    obs.disable()
    searches = len(runs)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    slices = []
    if traced:
        spec = mix["trace"]
        prof = trace_lib.SliceProfiler(spec["slices"])
        req = request(traffic_lib.search_seed(seed, searches),
                      on_progress=prof,
                      progress_every=int(spec["progress_every"]))
        runs.append((req, api.run_search(req)))
        slices = prof.slices()

    data = RunData(cell, setup_s, window_s, searches, spans, slices)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(root, m["name"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # The judgement runs once the window is over and its peak read.
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    verdict = check.judge(runs, cfg, mix, dev)
    numbers = verdict["numbers"]
    ok = check.correct(numbers)
    failed = sum(1 for _, o in runs if not o.feasible)

    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit_w() if dev.type == "cuda" else None}
    result = {"correct": ok, "attempted": len(runs), "failed": failed,
              "metrics": metrics, "device": info}
    if traced:
        info["busy_s"] = sum(s.busy_s for s in slices)
        info["window_s"] = sum(s.wall_s for s in slices)
        result["breakdown"] = trace_lib.breakdown(slices)
    result["checks"] = {k: {"value": _finite(v), "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    print(f"set-up {setup_s:.3f} s (imports {t_import:.3f} s), window "
          f"searches {[round(w, 3) for w in walls]} s, power limit "
          f"{info['power_limit_w']} W", file=log)
    for s in slices:
        print(f"traced slice {s.phase}: {s.steps} steps, wall {s.wall_s:.4f}"
              f" s, device busy {s.busy_s:.4f} s", file=log)
    print(f"searches judged {len(runs)}, policy epochs compared "
          f"{verdict['details']['policy_epochs']}", file=log)
    for k, v in numbers.items():
        print(f"{k} {v!r} limit {check.LIMITS[k]!r}", file=log)
    print(f"correct {str(ok).lower()}", file=log)
    return result
