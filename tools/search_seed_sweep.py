#!/usr/bin/env python3
"""Search outcomes of the port's CLI over seeds, for one or more trees.

    python3 tools/search_seed_sweep.py --seeds 10 --jobs 7 \
        --tree this=src --tree parent=_archive/parent/src

Runs ``python -m repro_torch.launch.search`` (``chip_smoke.py`` phase 6's
``two_stage`` config by default: mobilenet_v2, latency / area / iot / dla,
LP, 1000 stage-1 epochs, local GA of population 20 for 2000 generations)
once per seed and tree, ``--jobs`` processes at a time, each importing
``repro_torch`` from its tree's ``src`` directory.  Prints one JSON line
per run (the CLI's summary) and then one summary line per tree: the best
values by seed, their median, minimum and maximum.  The runs share the
card and the host, so their wall seconds are not comparable; only the
outcomes are.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_one(src, seed, extra):
    env = dict(os.environ, PYTHONPATH=str(Path(src).resolve()),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.search",
           "--seed", str(seed), *extra]
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode not in (0, 1) or not lines:
        raise RuntimeError(f"{cmd} under {src} exited {proc.returncode}:\n"
                           f"{proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=SRC_DIR; repeatable (default: this=src)")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--args", default="--workload mobilenet_v2 --method "
                    "two_stage --epochs 1000 --ga-population 20 "
                    "--ga-generations 2000 --device cuda",
                    help="the CLI's arguments, besides --seed")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree) or {"this": "src"}
    extra = args.args.split()
    jobs = [(label, src, seed) for seed in range(args.seeds)
            for label, src in trees.items()]
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(lambda j: run_one(j[1], j[2], extra), jobs))
    by_tree = {label: {} for label in trees}
    for (label, _, seed), res in zip(jobs, results):
        print(json.dumps({"tree": label, "seed": seed, "summary": res}),
              flush=True)
        by_tree[label][seed] = res["best_value"]
    for label, vals in by_tree.items():
        finite = [v for v in vals.values()
                  if v is not None and v != float("inf")]
        print(json.dumps({
            "tree": label, "best_value_by_seed": vals,
            "feasible": len(finite), "runs": len(vals),
            "median": statistics.median(finite) if finite else None,
            "min": min(finite, default=None),
            "max": max(finite, default=None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
