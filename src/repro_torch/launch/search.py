"""ConfuciuX search launcher of the PyTorch port: a registered optimizer
as a CLI.

    PYTHONPATH=src python -m repro_torch.launch.search \
        --workload mobilenet_v2 --objective latency --constraint area \
        --platform iot --dataflow dla --epochs 5000 --device cuda \
        --out results/search_torch.json

    # The latency-energy frontier of an assigned architecture's serving
    # workload (NSGA-II; the record gains ``frontier``):
    PYTHONPATH=src python -m repro_torch.launch.search --arch qwen3-32b \
        --tokens 512 --method nsga2 --epochs 6400 --archive 128

    # Ten seeds of reinforce at once, the shards' epoch graphs side by
    # side on the card (the last line adds the fanout's extras):
    PYTHONPATH=src python -m repro_torch.launch.search \
        --workload mobilenet_v2 --method fanout --fanout-inner reinforce \
        --fanout-shards 10 --fanout-backend device --epochs 1000

The flags and the last-line JSON are those of ``repro.launch.search`` for
the methods this package registers (``api.list_optimizers()``: two_stage,
reinforce, a2c, ppo2, relaxed, ga, nsga2, sa, bo, random, grid, fanout and
dist_reinforce, which runs on the default mesh: the ranks of an
initialised ``torch.distributed`` world, else one device), plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels) and, for fanout, its extras (``inner``,
``n_shards``, ``backend``, ``total_samples``, ``shard_best_values``,
``best_seed``) in the last line and the ``--out`` record.  ``--arch``
lowers an assigned architecture at ``--tokens`` positions
(``costmodel.arch_workloads``).  On the card, stage 1
(two_stage, reinforce, dist_reinforce) replays its epoch as one CUDA
graph; a2c and ppo2
run their epochs eagerly.  ``--trace-out`` / ``--metrics-out`` /
``--profile`` turn on telemetry (``repro_torch.obs``), as in the
reference.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch import api, obs
from repro_torch.core import env as env_lib
from repro_torch.costmodel import arch_workloads
from repro_torch.costmodel import dataflows as dfl
from repro_torch.costmodel import workloads as workloads_lib
from repro_torch.costmodel.layers import total_macs


def build_request(args) -> api.SearchRequest:
    """Translate CLI flags into the canonical SearchRequest."""
    if args.workload:
        wl = workloads_lib.get_workload(args.workload)
    else:
        wl = arch_workloads.lower_arch(args.arch, tokens=args.tokens)
    mix = args.dataflow == "mix"
    ecfg = env_lib.EnvConfig(
        objective=args.objective, constraint=args.constraint,
        platform=args.platform, scenario=args.scenario,
        dataflow=(dfl.DLA if mix
                  else dfl.DATAFLOW_NAMES.index(args.dataflow)),
        mix=mix, levels=args.levels,
        blend_weight=args.blend_weight)
    # GA flags feed both the two_stage fine-tuner (nested "ga" dict) and
    # --method ga / nsga2 (top-level keys); unset flags keep each method's
    # defaults.
    ga_opts = {k: v for k, v in (("population", args.ga_population),
                                 ("generations", args.ga_generations))
               if v is not None}
    options = {
        "episodes_per_epoch": args.episodes,
        "fine_tune": not args.no_finetune,
        "ga": ga_opts,
        **ga_opts,
    }
    if args.archive is not None:
        options["archive"] = args.archive
    if args.lr is not None:      # unset keeps each method's own default
        options["lr"] = args.lr
    # Relaxed-engine knobs (ignored by every other method).
    for k, v in (("steps_per_eval", args.relaxed_steps),
                 ("restarts", args.relaxed_restarts),
                 ("tau_start", args.tau_start),
                 ("tau_min", args.tau_min)):
        if v is not None:
            options[k] = v
    if args.method == "fanout":
        # The per-method knobs collected above configure the *inner* method;
        # the fanout layer itself takes the shard/backend flags.
        options = {"inner": args.fanout_inner,
                   "n_shards": args.fanout_shards,
                   "backend": args.fanout_backend,
                   "inner_options": options}
    # eps counts whole-model evaluations; --epochs keeps the paper's
    # epoch semantics (one epoch = --episodes samples for the RL family).
    return api.SearchRequest(
        workload=wl, env=ecfg, eps=args.epochs * args.episodes,
        seed=args.seed, method=args.method, options=options,
        device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--workload", help="paper workload name "
                     f"(one of {workloads_lib.workload_names()})")
    src.add_argument("--arch", help="assigned architecture id (the model is "
                     "lowered to its per-layer GEMM/CONV descriptors)")
    ap.add_argument("--tokens", type=int, default=256,
                    help="tokens per forward for --arch lowering")
    ap.add_argument("--method", default="two_stage",
                    help="search method from the unified registry "
                    f"(one of {', '.join(api.list_optimizers())})")
    ap.add_argument("--objective", default="latency",
                    choices=["latency", "energy", "blend"],
                    help="whole-model objective; 'blend' scalarizes "
                    "lat^w * en^(1-w) with --blend-weight (sampling "
                    "methods only)")
    ap.add_argument("--blend-weight", type=float, default=0.5,
                    help="--objective blend: latency weight w in [0, 1]")
    ap.add_argument("--archive", type=int, default=None,
                    help="--method nsga2: Pareto-archive capacity "
                    "(default 128)")
    ap.add_argument("--constraint", default="area",
                    choices=["area", "power"])
    ap.add_argument("--platform", default="iot",
                    choices=["unlimited", "cloud", "iot", "iotx"])
    ap.add_argument("--scenario", default="LP", choices=["LP", "LS"])
    ap.add_argument("--dataflow", default="dla",
                    choices=["dla", "eye", "shi", "mix"])
    ap.add_argument("--levels", type=int, default=12, choices=[10, 12, 14])
    ap.add_argument("--epochs", type=int, default=5000,
                    help="sample budget Eps (in epochs of --episodes)")
    ap.add_argument("--episodes", type=int, default=1,
                    help="episodes per epoch (1 = the paper's setting)")
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 3e-3 for reinforce/two_stage, "
                    "1e-3 for a2c/ppo2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-finetune", action="store_true",
                    help="skip the stage-2 local GA (two_stage only)")
    ap.add_argument("--ga-generations", type=int, default=None,
                    help="default: 2000 for the two_stage fine-tuner, "
                    "eps/population for --method ga")
    ap.add_argument("--ga-population", type=int, default=None,
                    help="default: 20 for the two_stage fine-tuner, "
                    "100 for --method ga")
    ap.add_argument("--relaxed-steps", type=int, default=None,
                    help="--method relaxed: gradient steps per hard "
                    "evaluation (default 25)")
    ap.add_argument("--relaxed-restarts", type=int, default=None,
                    help="--method relaxed: parallel descent replicas "
                    "(default 4)")
    ap.add_argument("--tau-start", type=float, default=None,
                    help="--method relaxed: initial surrogate temperature "
                    "(default 1.0)")
    ap.add_argument("--tau-min", type=float, default=None,
                    help="--method relaxed: annealing floor (default 0.05)")
    ap.add_argument("--fanout-backend", default="auto",
                    choices=["auto", "device", "threads", "serial"],
                    help="--method fanout execution backend: every shard's "
                    "CUDA graphs driven from one thread, each shard on its "
                    "own stream (device; reinforce and ga), one host "
                    "thread per shard (threads), or an in-process loop "
                    "(serial); auto picks device for those inners on the "
                    "card, else threads")
    ap.add_argument("--fanout-inner", default="reinforce",
                    help="--method fanout: inner method each shard runs")
    ap.add_argument("--fanout-shards", type=int, default=4,
                    help="--method fanout: number of parallel searches")
    ap.add_argument("--progress-every", type=int, default=0,
                    help="stream best-so-far every N samples (0 = off)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the search runs; cuda fails without a card")
    ap.add_argument("--out", default="")
    ap.add_argument("--trace-out", default="",
                    help="write a span trace here (.jsonl = one span per "
                    "line, else Chrome-trace JSON for chrome://tracing / "
                    "ui.perfetto.dev); enables telemetry")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics registry here (.prom text "
                    "exposition, or .json snapshot); enables telemetry")
    ap.add_argument("--profile", action="store_true",
                    help="enable telemetry and print the flight-recorder "
                    "summary even without --trace-out/--metrics-out")
    args = ap.parse_args(argv)

    try:
        api.get_optimizer(args.method)
    except KeyError as e:
        ap.error(e.args[0])

    request = build_request(args)
    wl = request.workload
    target = args.workload or args.arch
    print(f"target={target} method={args.method} layers={len(wl)} "
          f"macs={total_macs(wl)/1e6:.0f}M obj={args.objective} "
          f"cstr={args.constraint}:{args.platform} df={args.dataflow} "
          f"scenario={args.scenario} eps={request.eps} "
          f"device={args.device}", flush=True)

    if args.progress_every > 0:
        request.progress_every = args.progress_every
        request.on_progress = lambda t: print(
            f"  [{t.step}/{request.eps}]"
            + (f" shard={t.shard}" if t.shard is not None else "")
            + f" best={t.best_value:.4e}",
            flush=True)

    profile = bool(args.profile or args.trace_out or args.metrics_out)
    if profile:
        obs.enable(trace=True)

    out = api.run_search(request)

    if profile:
        print(out.summary(), flush=True)
        if args.trace_out:
            obs.save_trace(args.trace_out)
            print(f"wrote {args.trace_out}", flush=True)
        if args.metrics_out:
            obs.write_prometheus(args.metrics_out)
            print(f"wrote {args.metrics_out}", flush=True)
        obs.disable()

    stage1 = out.extras.get("stage1_value")
    initial = out.extras.get("initial_valid_value")
    rec = {
        "target": target, "method": out.method,
        "objective": args.objective,
        "constraint": args.constraint, "platform": args.platform,
        "scenario": args.scenario, "dataflow": args.dataflow,
        "eps": out.eps, "epochs": args.epochs, "seed": out.seed,
        "device": args.device,
        "best_value": out.best_value,
        "feasible": out.feasible,
        "stage1_value": stage1,
        "initial_valid_value": initial,
        "stage1_improvement_pct": (
            100.0 * (1 - stage1 / initial)
            if initial is not None and np.isfinite(initial) else None),
        "stage2_improvement_pct": (
            100.0 * (1 - out.best_value / stage1)
            if stage1 is not None and np.isfinite(stage1) else None),
        "samples_to_convergence": out.samples_to_convergence,
        "wall_seconds": round(out.wall_seconds, 2),
    }
    if out.frontier is not None:
        # Multi-objective methods: the latency-energy trade-off curve.
        rec["frontier"] = {
            k: np.asarray(v).tolist()
            for k, v in out.frontier.items() if k not in ("pe", "kt", "df")}
        rec["frontier_size"] = len(out.frontier["lat"])
    if out.feasible:
        rec["assignment"] = {
            "pe": np.asarray(out.pe).astype(int).tolist(),
            "kt": np.asarray(out.kt).astype(int).tolist(),
            "dataflow": [dfl.DATAFLOW_NAMES[int(d)] for d in out.df],
            "layers": [l.name or f"layer{i}" for i, l in enumerate(wl)],
        }
    if out.telemetry is not None:
        rec["telemetry"] = out.telemetry
    summary = ["method", "best_value", "stage1_value", "initial_valid_value",
               "samples_to_convergence", "wall_seconds"]
    if out.method == "fanout":
        # The shards' epoch histories stay in the outcome: a line each.
        rec["fanout"] = {k: v for k, v in out.extras.items()
                         if k != "shard_histories"}
        summary.append("fanout")
    print(json.dumps({k: rec[k] for k in summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    return 0 if out.feasible else 1


if __name__ == "__main__":
    sys.exit(main())
