#!/usr/bin/env python3
"""The JAX package's arm of the search-quality check, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/search_quality_ref.py \
        --out results/search_quality_ref.json

Runs each configuration of ``CONFIGS`` for seeds 0-9 through
``repro.api.run_search``, each seed as its own run of the method: what
shard ``s`` of ``fanout`` runs with ``backend="serial"`` and seed 0.  Every
configuration is on mobilenet_v2 at full width (LSTM(128), L = 12,
latency / area, dla, LP).  A configuration whose options name a ``mesh``
(``[shape, axis names]``; Q4, ``dist_reinforce`` on a 2 x 4 pod x data
mesh) runs in a subprocess with that many forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count``), which builds the
mesh there.  ``--configs`` picks configurations; when ``--out`` exists,
their entries replace the file's and the others stay.  The file it
writes is plain JSON: the
configurations, one entry per run (config, seed, eps, ``best_value``,
``samples_to_convergence``, the run's wall seconds on the host CPU that
ran it, and the best assignment's pe / kt / df; an infeasible run has
``best_value`` null and no assignment), the JAX version and the
command.  ``chip_smoke.py`` phase 6d reads it and runs
the same configurations through the PyTorch port's ``fanout`` on the
card, and phase 6e runs Q4 through the port's ``dist_reinforce`` on a
virtual mesh of the same shape.  This tool imports JAX and the JAX package; nothing of the port
imports it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

WORKLOAD = "mobilenet_v2"
ENV = {"objective": "latency", "constraint": "area", "scenario": "LP",
       "dataflow": 0, "levels": 12}
# name -> (method, platform, eps, options)
CONFIGS = {
    "Q1": ("two_stage", "iot", 1000,
           {"ga": {"population": 20, "generations": 200}}),
    "Q2": ("reinforce", "iot", 1000, {}),
    "Q3": ("ga", "cloud", 5000, {"population": 100}),
    # 250 epochs of 16 episodes; shards 2 and 6 dead, the pod hop in int8.
    "Q4": ("dist_reinforce", "iot", 4000,
           {"mesh": [[2, 4], ["pod", "data"]], "episodes_per_device": 2,
            "compress_pod_axis": True,
            "straggler_mask": [True, True, False, True,
                               True, True, False, True]}),
}
SEEDS = tuple(range(10))


def _devices(opts) -> int:
    """The forced host devices a configuration's mesh needs (0: none)."""
    return math.prod(opts["mesh"][0]) if "mesh" in opts else 0


def _run_with_devices(name, n_devices, log):
    """Configuration ``name`` in a subprocess of this tool with
    ``n_devices`` forced host devices; its entries."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "part.json")
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
                   f"count={n_devices}")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--configs", name,
             "--out", out], env=env, stdout=subprocess.PIPE, text=True)
        for line in proc.stdout.splitlines():
            log(line)
        if proc.returncode:
            raise RuntimeError(f"{name}: the subprocess failed "
                               f"({proc.returncode})")
        with open(out) as f:
            return json.load(f)["entries"]


def run(configs, seeds, log=print):
    import jax
    import numpy as np

    from repro import api

    entries = []
    for name, (method, platform, eps, opts) in configs.items():
        n_dev = _devices(opts)
        if n_dev and len(jax.devices()) != n_dev:
            entries += _run_with_devices(name, n_dev, log)
            continue
        opts = dict(opts)
        if n_dev:
            opts["mesh"] = jax.make_mesh(tuple(opts["mesh"][0]),
                                         tuple(opts["mesh"][1]))
        for seed in seeds:
            t0 = time.perf_counter()
            out = api.run_search(api.SearchRequest(
                workload=WORKLOAD, env=api.EnvConfig(platform=platform,
                                                     **ENV),
                eps=eps, seed=seed, method=method, options=dict(opts)))
            feasible = bool(math.isfinite(out.best_value))
            entry = {"config": name, "seed": seed, "eps": eps,
                     "best_value": out.best_value if feasible else None,
                     "samples_to_convergence": out.samples_to_convergence,
                     "seconds": time.perf_counter() - t0}
            if feasible:
                entry.update(pe=np.asarray(out.pe, float).tolist(),
                             kt=np.asarray(out.kt, float).tolist(),
                             df=np.asarray(out.df, int).tolist())
            entries.append(entry)
            log(json.dumps({k: entry[k] for k in
                            ("config", "seed", "best_value", "seconds")}))
    return {"workload": WORKLOAD, "env": ENV,
            "configs": {k: {"method": m, "platform": p, "eps": e,
                            "options": o}
                        for k, (m, p, e, o) in configs.items()},
            "seeds": list(seeds), "entries": entries,
            "jax_version": jax.__version__,
            "command": " ".join(["python3", "tools/search_quality_ref.py",
                                 *sys.argv[1:]])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/search_quality_ref.json")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated names of CONFIGS to run")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    configs = {k: CONFIGS[k] for k in args.configs.split(",")}
    res = run(configs, SEEDS)
    out = Path(args.out)
    if out.is_file():          # keep the other configurations' entries
        old = json.loads(out.read_text())
        res["configs"] = {**{k: v for k, v in old["configs"].items()
                             if k not in configs}, **res["configs"]}
        res["entries"] = [e for e in old["entries"]
                          if e["config"] not in configs] + res["entries"]
        if set(old["configs"]) - set(configs):
            res["command"] = f"{old['command']}; {res['command']}"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
