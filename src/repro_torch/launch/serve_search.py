"""Search-as-a-service launcher of the PyTorch port: many users' searches on
one card.

    # 12 synthetic users mixing methods over two popular workloads:
    PYTHONPATH=src python -m repro_torch.launch.serve_search \
        --workloads ncf,mobilenet_v2 --methods random,grid,bo,reinforce \
        --n 12 --eps 600 --progress --out results/serve_search_torch.json

    # On the CPU, with the kernels' plain versions:
    PYTHONPATH=src python -m repro_torch.launch.serve_search --device cpu \
        --workloads ncf --methods random,grid,ga --n 6 --eps 200

    # An explicit request mix from a JSON spec (a list of request dicts;
    # unknown keys go into options):
    PYTHONPATH=src python -m repro_torch.launch.serve_search --spec mix.json

The flags and the summary line are those of ``repro.launch.serve_search``,
plus ``--device`` (default ``cuda``; without a card it fails, and nothing
falls back to the CPU).  ``--trace-out`` / ``--metrics-out`` /
``--profile`` turn on telemetry (``repro_torch.obs``) and add each
search's flight-recorder summary to its result row.  Every request is a unified-API ``SearchRequest``
dispatched through :class:`repro_torch.serving.SearchService`:
random/grid/bo, ga and sa fuse their cost evaluations into one
cross-request dispatch stream with a shared per-point memo cache; the RL
family (reinforce, two_stage) interleaves at chunk granularity.  The exit
summary reports searches/sec, the cache hit rate and the batcher fusion
stats.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch import api, obs
from repro_torch.core import env as env_lib
from repro_torch.costmodel import dataflows as dfl
from repro_torch.serving import SearchService, ServiceConfig


def _synthetic_requests(args):
    """Round-robin (workload x method) mix; each distinct query is
    submitted by ``--repeat`` users (identical popular queries)."""
    workloads = args.workloads.split(",")
    methods = args.methods.split(",")
    reqs = []
    for u in range(args.n):
        q = u // args.repeat          # users in a repeat group share the
        reqs.append(dict(             # whole query, not just the seed
            workload=workloads[q % len(workloads)],
            method=methods[q % len(methods)],
            eps=args.eps, seed=args.seed + q))
    return reqs


def _to_request(spec: dict, args) -> api.SearchRequest:
    spec = dict(spec)
    ecfg = env_lib.EnvConfig(
        objective=spec.pop("objective", "latency"),
        constraint=spec.pop("constraint", "area"),
        platform=spec.pop("platform", args.platform),
        scenario=spec.pop("scenario", "LP"),
        dataflow=dfl.DATAFLOW_NAMES.index(spec.pop("dataflow", "dla")))
    workload = spec.pop("workload")
    eps = int(spec.pop("eps", args.eps))
    seed = int(spec.pop("seed", 0))
    method = spec.pop("method", "two_stage")
    # Leftover unknown keys merge into options (an explicit "options"
    # dict wins on conflicts).
    explicit = spec.pop("options", {})
    options = {**spec, **explicit}
    return api.SearchRequest(workload=workload, env=ecfg, eps=eps,
                             seed=seed, method=method, options=options,
                             device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spec", default="",
                    help="JSON file with a list of request dicts")
    ap.add_argument("--workloads", default="ncf,mobilenet_v2",
                    help="comma list cycled across synthetic users")
    ap.add_argument("--methods", default="random,grid,bo",
                    help="comma list cycled across synthetic users")
    ap.add_argument("--n", type=int, default=8,
                    help="number of synthetic requests")
    ap.add_argument("--repeat", type=int, default=2,
                    help="users per distinct seed -- models identical "
                    "popular queries hitting the memo cache")
    ap.add_argument("--eps", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default="cloud",
                    choices=["unlimited", "cloud", "iot", "iotx"])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--dispatch-workers", type=int, default=1,
                    help="fused-dispatch pool size in the cost-eval batcher")
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--cache-dir", default="",
                    help="persist the cost memo cache here (versioned "
                    "shard files); warm restarts reload it")
    ap.add_argument("--progress", action="store_true",
                    help="stream per-request progress lines")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the service runs; cuda fails without a card")
    ap.add_argument("--out", default="")
    ap.add_argument("--trace-out", default="",
                    help="write a span trace here (.jsonl = one span per "
                    "line, else Chrome-trace JSON); enables telemetry")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics registry here (.prom text "
                    "exposition, or .json snapshot); enables telemetry")
    ap.add_argument("--profile", action="store_true",
                    help="enable telemetry and print per-search "
                    "flight-recorder summaries")
    args = ap.parse_args(argv)

    profile = bool(args.profile or args.trace_out or args.metrics_out)
    if profile:
        obs.enable(trace=True)

    if args.spec:
        with open(args.spec) as f:
            specs = json.load(f)
    else:
        specs = _synthetic_requests(args)
    requests = [_to_request(s, args) for s in specs]

    print(f"serving {len(requests)} searches on {args.workers} workers "
          f"({args.dispatch_workers} dispatch, window {args.window_ms}ms, "
          f"device {args.device})", flush=True)
    svc = SearchService(ServiceConfig(max_workers=args.workers,
                                      window_ms=args.window_ms,
                                      device=args.device,
                                      dispatch_workers=args.dispatch_workers,
                                      cache_dir=args.cache_dir or None))
    t0 = time.time()
    tickets = []
    for i, r in enumerate(requests):
        if args.progress:
            r.on_progress = (lambda i=i: lambda t: print(
                f"  [req{i}] step={t.step} best={t.best_value:.4e}",
                flush=True))()
            r.progress_every = max(r.eps // 4, 1)
        tickets.append(svc.submit(r))

    rows = []
    for i, (t, spec) in enumerate(zip(tickets, specs)):
        try:
            out = t.result()
            row = {"req": i, "workload": str(spec.get("workload")),
                   "method": out.method, "seed": out.seed,
                   "best_value": out.best_value,
                   "feasible": out.feasible,
                   "wall_seconds": round(t.wall_seconds, 2)}
            if out.telemetry is not None:
                row["telemetry"] = out.telemetry
            rows.append(row)
        except Exception as e:  # noqa: BLE001 -- reported per request
            rows.append({"req": i, "status": t.status, "error": repr(e)})
    wall = time.time() - t0
    stats = svc.stats()
    svc.close()

    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {
        "requests": len(requests), "wall_seconds": round(wall, 2),
        "searches_per_sec": round(len(requests) / wall, 3),
        "cache_hit_rate": round(stats["cache_hit_rate"], 4),
        "fused_dispatches": stats["fused_dispatches"],
        "dispatches": stats["dispatches"],
        "points": stats["points"], "fresh_points": stats["fresh_points"],
        # dedup + cache together: fraction of requested points that never
        # reached the cost model (concurrent identical queries fuse into
        # the same dispatch, so they show up here rather than as hits).
        "points_eliminated_frac": round(
            1.0 - stats["fresh_points"] / max(stats["points"], 1), 4),
    }
    print(json.dumps(summary), flush=True)
    if profile:
        if args.trace_out:
            obs.save_trace(args.trace_out)
            print(f"wrote {args.trace_out}", flush=True)
        if args.metrics_out:
            obs.write_prometheus(args.metrics_out)
            print(f"wrote {args.metrics_out}", flush=True)
        obs.disable()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "results": rows,
                       "stats": stats}, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    # Exit status reflects SERVICE health, not search feasibility: an
    # infeasible outcome under a tight budget is a correct answer (the
    # paper's "NAN"), not a failed request.
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
