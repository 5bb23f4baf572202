#!/usr/bin/env python3
"""The JAX package's arm of the search-quality check, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/search_quality_ref.py \
        --out results/search_quality_ref.json

Runs each configuration of ``CONFIGS`` for seeds 0-9 through
``repro.api.run_search``, each seed as its own run of the method: what
shard ``s`` of ``fanout`` runs with ``backend="serial"`` and seed 0.  Every
configuration is on mobilenet_v2 at full width (LSTM(128), L = 12,
latency / area, dla, LP).  The file it writes is plain JSON: the
configurations, one entry per run (config, seed, eps, ``best_value``,
``samples_to_convergence``, the run's wall seconds on the host CPU that
ran it, and the best assignment's pe / kt / df; an infeasible run has
``best_value`` null and no assignment), the JAX version and the
command.  ``chip_smoke.py`` phase 6d reads it and runs
the same configurations through the PyTorch port's ``fanout`` on the
card.  This tool imports JAX and the JAX package; nothing of the port
imports it.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
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
}
SEEDS = tuple(range(10))


def run(configs, seeds, log=print):
    import jax
    import numpy as np

    from repro import api

    entries = []
    for name, (method, platform, eps, opts) in configs.items():
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
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
