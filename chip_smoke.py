#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --out results/chip_smoke.json   # also a JSON

Phases, in order; the first failure stops the script with a non-zero exit
and no result line:

1. Device: require CUDA; print the card's name and power limit.
2. Build both CUDA sources from ``src/repro_torch/kernels/csrc`` (nvcc, in
   parallel; the cost library holds two kernels) and print the build
   seconds.
3. Cost kernel vs its plain version on the card (rtol 1e-5, atol 1e-2):
   every paper workload x 3 dataflows x the 12 x 12 level grid, random raw
   points at (4096, 53), ragged shapes (1, 1), (3, 7), (13, 130).
   Then the per-row cost kernel vs its plain version (rtol 1e-5, atol
   1e-2): the six paper workloads as ragged rows padded with repeat = 0
   rows x 3 dataflows x random level points, random raw points at
   (1, 5300) and (1, 27136) (a GA generation of 100 and a random-search
   batch of 512 on mobilenet_v2), ragged (1, 1), (3, 7), (13, 130);
   padding rows exactly 0, and rows of one workload bit-equal to the
   single-table kernel.
4. LSTM kernel vs its plain version (atol 1e-5) at the repo's shapes, and
   the kernel's autograd Function against autograd through the plain
   version (atol 1e-5).
5. Main path: ``api.run_search`` with method two_stage on mobilenet_v2 at
   full width (LSTM(128), L=12, latency / area / iot / dla, local GA with
   population 20 and 2000 generations), then method ga (population 100,
   5000 generations).  Only the epoch count is cut (the paper uses 5000).
   Every launch counter is set to 0 just before and read just after; each
   kernel must have launched as often as the run implies, and no plain
   version may have run on the card.  Each outcome must be feasible, have
   a monotone history of length eps, and its best re-scored by the plain
   version on the CPU must match best_value (rtol 1e-5).
6. Service path: eight requests (ga x 3, random, grid, sa, bo, reinforce;
   ``SERVICE_REQUESTS``) run serially through ``api.run_search`` on the
   card, then submitted together to
   ``SearchService(ServiceConfig(max_workers=8, window_ms=2.0,
   device="cuda"))``.  The launch counters are set to 0 just before the
   service run and read just after.  Each outcome must equal its serial
   run byte for byte (best_value, history, pe, kt, df); the batcher must
   have fused dispatches and hit its cache; the per-row kernel must have
   launched at least once and at most once per dispatch; no plain version
   may have run on the card.
7. Kernel timings with CUDA events at the paths' shapes, printed as one
   ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Nothing here imports
JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Float32 operations per design point in csrc/costmodel_eval.cu, counted
# from its source (compares, selects, min/max, ceil/floor and sqrt count
# as one operation each).
COST_OPS_PER_POINT = 224
# Float32 operations per hidden unit in the LSTM tail (3 sigmoids at 4,
# 2 tanh at 1, 4 bias adds, 2 sums of partial products, c' and h').
LSTM_TAIL_OPS_PER_UNIT = 24
# The main path's size: stage-1 epochs (= eps; the paper uses 5000, this
# is the only cut), local-GA generations of the two-stage run, and the
# baseline GA's generations at population 100.
EPOCHS = 1000
GA_GENERATIONS = 2000
BASELINE_GA_GENERATIONS = 5000
# Bytes the per-row cost kernel moves per point: 8 layer fields, pe, kt,
# df in, four costs out, all float32.
MULTI_BYTES_PER_POINT = 4 * (8 + 3 + 4)
# The service path: (method, workload, eps, seed, options), all at
# latency / area / iot / dla, LP.  Requests 1 and 2 are the same query
# from two users.
SERVICE_REQUESTS = (
    ("ga", "mobilenet_v2", 50_000, 0, {"population": 100}),
    ("ga", "mobilenet_v2", 50_000, 0, {"population": 100}),
    ("ga", "resnet50", 50_000, 1, {"population": 100}),
    ("random", "mobilenet_v2", 5_000, 0, {}),
    ("grid", "ncf", 5_000, 0, {}),
    ("sa", "mobilenet_v2", 2_000, 0, {}),
    ("bo", "mnasnet", 1_000, 0, {}),
    ("reinforce", "ncf", 50, 0, {}),
)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters, warmup=20):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    return line


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build()
    total = time.perf_counter() - t0
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"total {total:.2f}s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return total


def _layers_table(arr, dev):
    import torch

    return torch.as_tensor(arr, dtype=torch.float32, device=dev).T.contiguous()


def phase_cost_kernel(dev):
    """Kernel vs plain version on the card; returns the worst errors."""
    import numpy as np
    import torch

    from repro_torch.costmodel import dataflows as dfl
    from repro_torch.costmodel import layers as layers_lib
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import costmodel_eval, ref

    worst = {"abs": 0.0, "rel": 0.0, "points": 0}

    def compare(layers_t, pe, kt, df, what):
        got = costmodel_eval.cost_eval(layers_t, pe, kt, df)
        want = ref.cost_eval_ref(layers_t, pe, kt, df)
        torch.cuda.synchronize()
        for g, w, field in zip(got, want, ("lat", "en", "area", "pw")):
            ok = torch.isclose(g, w, rtol=1e-5, atol=1e-2)
            check(bool(ok.all()), f"cost kernel disagrees on {what} {field}: "
                  f"max abs {float((g - w).abs().max())}")
            diff = (g - w).abs()
            worst["abs"] = max(worst["abs"], float(diff.max()))
            worst["rel"] = max(worst["rel"], float(
                (diff / w.abs().clamp_min(1e-30)).max()))
        worst["points"] += pe.numel()

    L = 12
    pe_g, kt_g = np.meshgrid(dfl.pe_levels(L), dfl.kt_levels(L),
                             indexing="ij")
    for name in workloads.workload_names():
        arr = layers_lib.layers_to_array(workloads.get_workload(name))
        N = arr.shape[0]
        lt = _layers_table(arr, dev)
        pe = torch.tensor(np.tile(pe_g.reshape(-1, 1), (1, N)),
                          dtype=torch.float32, device=dev)
        kt = torch.tensor(np.tile(kt_g.reshape(-1, 1), (1, N)),
                          dtype=torch.float32, device=dev)
        for df in range(3):
            compare(lt, pe, kt, torch.full_like(pe, float(df)),
                    f"{name} df={df}")

    rng = np.random.default_rng(0)
    mobilenet = layers_lib.layers_to_array(workloads.get_workload(
        "mobilenet_v2"))
    for (B, N), arr in (((4096, 53), mobilenet), ((1, 1), None),
                        ((3, 7), None), ((13, 130), None)):
        arr = _rand_layers(rng, N) if arr is None else arr
        f = lambda lo, hi: torch.tensor(rng.integers(lo, hi, (B, N)),
                                        dtype=torch.float32, device=dev)
        compare(_layers_table(arr, dev), f(1, 161), f(1, 17), f(0, 3),
                f"random ({B}, {N})")
    log(f"[cost] kernel == plain on {worst['points']} points: max abs err "
        f"{worst['abs']:.6g}, max rel err {worst['rel']:.3g} "
        "(rtol 1e-5, atol 1e-2)")
    return worst


def _rand_layers(rng, n):
    """n random conv / dwconv / gemm layer rows, (n, NUM_FIELDS)."""
    from repro_torch.costmodel import layers as layers_lib

    out = []
    for _ in range(n):
        t = rng.integers(0, 3)
        if t == 2:
            out.append(layers_lib.LayerSpec.gemm(
                *(int(v) for v in rng.integers(1, 512, 3))))
        elif t == 1:
            out.append(layers_lib.LayerSpec.dwconv(
                int(rng.integers(1, 256)), int(rng.integers(7, 64)),
                int(rng.integers(7, 64)), 3, 3))
        else:
            out.append(layers_lib.LayerSpec.conv(
                int(rng.integers(1, 256)), int(rng.integers(1, 256)),
                int(rng.integers(7, 64)), int(rng.integers(7, 64)), 3, 3))
    return layers_lib.layers_to_array(out)


def _flat_points(arr, M, rng, dev):
    """M points cycling over the layer rows of ``arr``, with random raw
    pe (1..160), kt (1..16) and df (0..2), as flat kernel inputs."""
    import numpy as np
    import torch

    layers = np.tile(arr, (-(-M // len(arr)), 1))[:M]
    f = lambda lo, hi: torch.tensor(rng.integers(lo, hi, M),
                                    dtype=torch.float32, device=dev)
    return (torch.as_tensor(layers, dtype=torch.float32, device=dev),
            f(1, 161), f(1, 17), f(0, 3))


def phase_multi_kernel(dev):
    """Per-row kernel vs plain version on the card; returns the worst
    errors."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.costmodel import dataflows as dfl
    from repro_torch.costmodel import layers as layers_lib
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import costmodel_eval, ref

    worst = {"abs": 0.0, "rel": 0.0, "points": 0}

    def compare(layers, pe, kt, df, what):
        got = costmodel_eval.cost_eval_multi(layers, pe, kt, df)
        want = ref.cost_eval_multi_ref(layers, pe, kt, df)
        torch.cuda.synchronize()
        for g, w, field in zip(got, want, ("lat", "en", "area", "pw")):
            ok = torch.isclose(g, w, rtol=1e-5, atol=1e-2)
            check(bool(ok.all()), f"per-row cost kernel disagrees on {what} "
                  f"{field}: max abs {float((g - w).abs().max())}")
            diff = (g - w).abs()
            worst["abs"] = max(worst["abs"], float(diff.max()))
            worst["rel"] = max(worst["rel"], float(
                (diff / w.abs().clamp_min(1e-30)).max()))
        worst["points"] += pe.numel()
        return got

    rng = np.random.default_rng(2)
    # The six paper workloads as ragged rows, padded with repeat = 0 rows.
    packs = [layers_lib.layers_to_array(workloads.get_workload(n))
             for n in workloads.workload_names()]
    N = max(len(p) for p in packs)
    pad = dataclasses.replace(layers_lib.LayerSpec.gemm(1, 1, 1),
                              repeat=0).as_row()
    rows = np.stack([np.concatenate([p, np.tile(pad, (N - len(p), 1))])
                     for p in packs]).astype(np.float32)      # (6, N, 8)
    draws = 24
    layers = torch.as_tensor(np.tile(rows, (draws, 1, 1)).reshape(-1, 8),
                             device=dev)
    levels = lambda table: torch.as_tensor(
        table[rng.integers(0, len(table), layers.shape[0])],
        dtype=torch.float32, device=dev)
    real = np.tile(np.arange(N)[None] < np.array([len(p) for p in packs])[
        :, None], (draws, 1)).reshape(-1)
    for df in range(3):
        pe, kt = levels(dfl.pe_levels(12)), levels(dfl.kt_levels(12))
        got = compare(layers, pe, kt, torch.full_like(pe, float(df)),
                      f"ragged paper rows df={df}")
        pad_mask = torch.as_tensor(~real, device=dev)
        check(all(bool((g[pad_mask] == 0).all()) for g in got),
              "per-row cost kernel: a repeat = 0 padding row is not 0")

    mobilenet = layers_lib.layers_to_array(workloads.get_workload(
        "mobilenet_v2"))
    for M in (5300, 27136):
        compare(*_flat_points(mobilenet, M, rng, dev),
                f"random raw points (1, {M})")
    for B, n in ((1, 1), (3, 7), (13, 130)):
        compare(*_flat_points(_rand_layers(rng, B * n), B * n, rng, dev),
                f"random ragged ({B}, {n})")

    # Rows that all carry one workload: bit-equal to the table kernel.
    for name in workloads.workload_names():
        arr = layers_lib.layers_to_array(workloads.get_workload(name))
        n = len(arr)
        B = 100
        f = lambda lo, hi: torch.tensor(rng.integers(lo, hi, (B, n)),
                                        dtype=torch.float32, device=dev)
        pe, kt, df = f(1, 161), f(1, 17), f(0, 3)
        table = costmodel_eval.cost_eval(_layers_table(arr, dev), pe, kt, df)
        per_row = costmodel_eval.cost_eval_multi(
            torch.as_tensor(np.tile(arr, (B, 1)), dtype=torch.float32,
                            device=dev),
            pe.reshape(-1), kt.reshape(-1), df.reshape(-1))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b.reshape(B, n))
                  for a, b in zip(table, per_row)),
              f"per-row kernel differs from the table kernel on {name}")
    log(f"[cost_multi] kernel == plain on {worst['points']} points: max abs "
        f"err {worst['abs']:.6g}, max rel err {worst['rel']:.3g} (rtol "
        "1e-5, atol 1e-2); padding rows 0; one-workload rows bit-equal to "
        "the table kernel")
    return worst


def _lstm_inputs(B, I, H, dev, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f = lambda *s, scale=0.1: torch.randn(s, generator=gen,
                                          device=dev) * scale
    return (f(B, I, scale=1.0), f(B, H), f(B, H), f(I, 4 * H), f(H, 4 * H),
            f(4 * H))


def phase_lstm_kernel(dev):
    import torch

    from repro_torch.kernels import lstm_cell, ref

    worst = {"fwd": 0.0, "grad": 0.0}
    for k, (B, I, H) in enumerate(((1, 10, 128), (64, 10, 128),
                                   (8, 11, 128), (16, 130, 128),
                                   (3, 10, 256))):
        args = _lstm_inputs(B, I, H, dev, seed=k)
        got = lstm_cell.lstm_cell(*args)
        want = ref.lstm_cell_ref(*args)
        for g, w in zip(got, want):
            err = float((g - w).abs().max())
            check(err <= 1e-5, f"LSTM kernel disagrees at {(B, I, H)}: {err}")
            worst["fwd"] = max(worst["fwd"], err)
        leaves = [a.clone().requires_grad_() for a in args]
        leaves_ref = [a.clone().requires_grad_() for a in args]
        h2, c2 = lstm_cell.LSTMCellFn.apply(*leaves)
        h3, c3 = ref.lstm_cell_ref(*leaves_ref)
        gen = torch.Generator(device=dev)
        gen.manual_seed(100 + k)
        dh, dc = (torch.randn((B, H), generator=gen, device=dev)
                  for _ in range(2))
        g_kernel = torch.autograd.grad((h2, c2), leaves, (dh, dc))
        g_plain = torch.autograd.grad((h3, c3), leaves_ref, (dh, dc))
        for name, g, w in zip(("x", "h", "c", "wx", "wh", "b"), g_kernel,
                              g_plain):
            err = float((g - w).abs().max())
            check(err <= 1e-5, f"LSTM gradient d{name} disagrees at "
                  f"{(B, I, H)}: {err}")
            worst["grad"] = max(worst["grad"], err)
    log(f"[lstm] kernel == plain: max abs err forward {worst['fwd']:.3g}, "
        f"gradient {worst['grad']:.3g} (atol 1e-5)")
    return worst


def _rescore_on_cpu(out, ecfg, wl):
    """Re-score an outcome's best with the plain version on the CPU."""
    from repro_torch.core import env as env_lib

    env = env_lib.make_env(wl, ecfg, device="cpu")
    perf, cons, _ = env_lib.genome_cost(env, ecfg, out.pe, out.kt, out.df)
    check(abs(float(perf) - out.best_value) <= 1e-5 * abs(out.best_value),
          f"{out.method}: re-scored best {float(perf)} != {out.best_value}")
    check(float(cons) <= float(env.budget) * (1 + 1e-6),
          f"{out.method}: reported best is infeasible on re-scoring")


def _check_outcome(out, eps):
    import numpy as np

    check(out.feasible, f"{out.method}: no feasible point found")
    check(len(out.history) == eps, f"{out.method}: history length")
    check(bool(np.all(out.history[1:] <= out.history[:-1])),
          f"{out.method}: history not monotone")
    check(out.history[-1] == out.best_value,
          f"{out.method}: history[-1] != best_value")


def phase_main_path(epochs, ga_generations):
    import torch

    from repro_torch import api
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import ops, ref

    wl = workloads.get_workload("mobilenet_v2")
    N = len(wl)
    ecfg = api.EnvConfig(objective="latency", constraint="area",
                         platform="iot", dataflow=0, levels=12)
    stamps = {}

    def stage_clock(trial):
        stamps.setdefault("stage1_end", time.perf_counter())

    two = api.SearchRequest(
        workload=wl, env=ecfg, eps=epochs, seed=0, method="two_stage",
        options={"ga": {"population": 20, "generations": ga_generations}},
        on_progress=stage_clock, progress_every=epochs, device="cuda")
    # The baseline GA gets 100 x 5000 samples: under the iot budget a
    # random genome is feasible about once in 1500 draws, and with far fewer
    # generations the GA can end without a feasible point.
    ga_pop, ga_gens = 100, BASELINE_GA_GENERATIONS
    ga = api.SearchRequest(workload=wl, env=ecfg, eps=ga_pop * ga_gens,
                           seed=0, method="ga",
                           options={"population": ga_pop}, device="cuda")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_two = api.run_search(two)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_ga = api.run_search(ga)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    plain_on_card = dict(ref.cuda_calls)

    # make_env evaluates C_max once per search; stage 1 scores every layer
    # of every epoch; each GA generation is one population evaluation.
    want_cost = (1 + N * epochs + ga_generations) + (1 + ga_gens)
    check(counts["cost_eval"] == want_cost,
          f"cost kernel launched {counts['cost_eval']} times, the run "
          f"implies {want_cost}")
    check(counts["lstm_cell"] >= N * epochs,
          f"LSTM kernel launched {counts['lstm_cell']} times, fewer than "
          f"{N} x {epochs}")
    check(all(v == 0 for v in plain_on_card.values()),
          f"a plain version ran on the card: {plain_on_card}")
    for out, eps in ((out_two, epochs), (out_ga, ga.eps)):
        _check_outcome(out, eps)
        _rescore_on_cpu(out, ecfg, wl)
        log(json.dumps({
            "method": out.method, "best_value": out.best_value,
            "stage1_value": out.extras.get("stage1_value"),
            "initial_valid_value": out.extras.get("initial_valid_value"),
            "samples_to_convergence": out.samples_to_convergence,
            "wall_seconds": out.wall_seconds}))
    s1 = stamps["stage1_end"] - t0
    timing = {"epochs": epochs, "ga_generations": ga_generations,
              "two_stage_s": t1 - t0, "stage1_s": s1,
              "stage1_ms_per_epoch": 1e3 * s1 / epochs,
              "stage2_ms_per_generation": 1e3 * (t1 - t0 - s1)
              / ga_generations,
              "ga_s": t2 - t1, "ga_generations_baseline": ga_gens}
    log(f"[main] launches {json.dumps(counts)}; plain versions on the card "
        f"{json.dumps(plain_on_card)}; {json.dumps(timing)}")
    return counts, timing


def _service_requests(specs):
    from repro_torch import api

    ecfg = api.EnvConfig(objective="latency", constraint="area",
                         platform="iot", scenario="LP", dataflow=0,
                         levels=12)
    return [api.SearchRequest(workload=wl, env=ecfg, eps=eps, seed=seed,
                              method=method, options=dict(opts),
                              device="cuda")
            for method, wl, eps, seed, opts in specs]


def _same_outcome(a, b):
    return (a.best_value == b.best_value
            and a.history.tobytes() == b.history.tobytes()
            and a.pe.tobytes() == b.pe.tobytes()
            and a.kt.tobytes() == b.kt.tobytes()
            and a.df.tobytes() == b.df.tobytes())


def phase_service(dev, specs=SERVICE_REQUESTS):
    """The search service against serial runs of the same requests."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import SearchService, ServiceConfig

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [api.run_search(r) for r in _service_requests(specs)]
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0

    requests = _service_requests(specs)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with SearchService(ServiceConfig(max_workers=8, window_ms=2.0,
                                     device="cuda")) as svc:
        tickets = [svc.submit(r) for r in requests]
        outs = [t.result() for t in tickets]
        stats = svc.stats()
    torch.cuda.synchronize()
    service_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    plain_on_card = dict(ref.cuda_calls)

    for spec, got, want in zip(specs, outs, serial):
        check(_same_outcome(got, want),
              f"service outcome of {spec[:4]} differs from its serial run: "
              f"{got.best_value} vs {want.best_value}")
        check(len(got.history) == spec[2], f"{spec[:4]}: history length")
    dispatches = stats["dispatches"]
    check(stats["fused_dispatches"] > 0, "the batcher fused no dispatch")
    check(stats["cache_hit_rate"] > 0, "the memo cache had no hit")
    check(1 <= counts["cost_eval_multi"] <= dispatches,
          f"per-row kernel launched {counts['cost_eval_multi']} times in "
          f"{dispatches} dispatches")
    check(counts["lstm_cell"] > 0 and counts["cost_eval"] > 0,
          f"the reinforce request did not run the kernels: {counts}")
    check(all(v == 0 for v in plain_on_card.values()),
          f"a plain version ran on the card: {plain_on_card}")
    for spec, out, t in zip(specs, outs, tickets):
        log(json.dumps({"service": spec[0], "workload": spec[1],
                        "eps": spec[2], "best_value": out.best_value,
                        "feasible": out.feasible,
                        "wall_seconds": t.wall_seconds}))
    timing = {
        "requests": len(specs), "serial_s": serial_s,
        "service_s": service_s,
        "searches_per_sec": len(specs) / service_s,
        "cache_hit_rate": stats["cache_hit_rate"],
        "points": stats["points"], "unique_points": stats["unique_points"],
        "fresh_points": stats["fresh_points"],
        "points_eliminated_frac": 1.0 - stats["fresh_points"]
        / max(stats["points"], 1),
        "dispatches": dispatches,
        "fused_dispatches": stats["fused_dispatches"],
        "items_per_dispatch": stats["items"] / max(dispatches, 1),
        "max_items_per_dispatch": stats["max_items_per_dispatch"],
        "ms_per_dispatch": 1e3 * stats["dispatch_seconds"]
        / max(dispatches, 1)}
    log(f"[service] byte-identical to serial on {len(specs)} requests; "
        f"launches {json.dumps(counts)}; plain versions on the card "
        f"{json.dumps(plain_on_card)}; {json.dumps(timing)}")
    return counts, timing


def phase_timings(dev, counts, cost_err, lstm_err, multi_counts, multi_err):
    import numpy as np
    import torch

    from repro_torch.costmodel import layers as layers_lib
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import costmodel_eval, lstm_cell, ref

    arr = layers_lib.layers_to_array(workloads.get_workload("mobilenet_v2"))
    N = arr.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def cost_args(B, n):
        lt = _layers_table(arr[:n], dev)
        f = lambda hi: torch.randint(1, hi, (B, n), generator=gen,
                                     device=dev).to(torch.float32)
        return lt, f(161), f(17), torch.zeros((B, n), device=dev)

    by_shape = {}
    for B, n in ((1, 1), (20, N), (100, N), (144, N)):
        a = cost_args(B, n)
        by_shape[f"{B}x{n}"] = time_ms(lambda: costmodel_eval.cost_eval(*a),
                                       2000)
    a = cost_args(20, N)
    B = 20
    cost_bytes = 4 * (3 * B * N + 4 * B * N + 8 * N)
    cost_ops = COST_OPS_PER_POINT * B * N
    cost_entry = {
        "name": "cost_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/costmodel_eval.cu",
        "replaces": "src/repro/kernels/costmodel_eval.py:60",
        "tpu_kernel": "repro/kernels/costmodel_eval.py::cost_eval_padded",
        "shape": [B, N], "launches": counts["cost_eval"],
        "launches_per_run": counts["cost_eval"],
        "max_abs_err": cost_err["abs"], "max_err": cost_err["abs"],
        "max_rel_err": cost_err["rel"],
        "ms": by_shape[f"{B}x{N}"], "kernel_ms": by_shape[f"{B}x{N}"],
        "plain_ms": time_ms(lambda: ref.cost_eval_ref(*a), 300),
        "bound_ms": 1e3 * max(cost_bytes / HBM_BYTES_PER_S,
                              cost_ops / FP32_FLOP_PER_S),
        "bound_by": ("bytes" if cost_bytes / HBM_BYTES_PER_S
                     >= cost_ops / FP32_FLOP_PER_S else "operations"),
        "library_ms": None, "ms_by_shape": by_shape}

    Bl, I, H = 1, 10, 128
    x, h, c, wx, wh, b = _lstm_inputs(Bl, I, H, dev, seed=7)
    w_ih, w_hh = wx.T.contiguous(), wh.T.contiguous()
    zero_b = torch.zeros_like(b)
    lib_out = torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zero_b)
    ker_out = lstm_cell.lstm_cell(x, h, c, wx, wh, b)
    check(all(float((p - q).abs().max()) <= 1e-5
              for p, q in zip(lib_out, ker_out)),
          "torch.lstm_cell disagrees with the LSTM kernel")
    lstm_bytes = 4 * (Bl * I + 2 * Bl * H + I * 4 * H + H * 4 * H + 4 * H
                      + 2 * Bl * H)
    lstm_ops = 2 * Bl * (I + H) * 4 * H + LSTM_TAIL_OPS_PER_UNIT * Bl * H
    k_ms = time_ms(lambda: lstm_cell.lstm_cell(x, h, c, wx, wh, b), 2000)
    lstm_entry = {
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:57",
        "tpu_kernel": "repro/kernels/lstm_cell.py::lstm_cell_padded",
        "shape": [Bl, I, H], "launches": counts["lstm_cell"],
        "launches_per_run": counts["lstm_cell"],
        "max_abs_err": lstm_err["fwd"], "max_err": lstm_err["fwd"],
        "max_grad_err": lstm_err["grad"],
        "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": time_ms(lambda: ref.lstm_cell_ref(x, h, c, wx, wh, b),
                            1000),
        "bound_ms": 1e3 * max(lstm_bytes / HBM_BYTES_PER_S,
                              lstm_ops / FP32_FLOP_PER_S),
        "bound_by": ("bytes" if lstm_bytes / HBM_BYTES_PER_S
                     >= lstm_ops / FP32_FLOP_PER_S else "operations"),
        "library_ms": time_ms(
            lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zero_b), 1000)}

    # The per-row kernel at the service's flat shapes: one GA generation of
    # population 100 and one random-search batch of 512 on mobilenet_v2.
    rng = np.random.default_rng(3)
    multi_ms = {}
    for M in (5300, 27136):
        a = _flat_points(arr, M, rng, dev)
        multi_ms[f"1x{M}"] = time_ms(
            lambda: costmodel_eval.cost_eval_multi(*a), 2000)
    M = 5300
    a = _flat_points(arr, M, rng, dev)
    multi_bytes = MULTI_BYTES_PER_POINT * M
    multi_ops = COST_OPS_PER_POINT * M
    multi_entry = {
        "name": "cost_eval_multi", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/costmodel_eval.cu",
        "replaces": "src/repro/kernels/costmodel_eval.py:102",
        "tpu_kernel":
            "repro/kernels/costmodel_eval.py::cost_eval_multi_padded",
        "shape": [1, M], "launches": multi_counts["cost_eval_multi"],
        "launches_per_run": multi_counts["cost_eval_multi"],
        "max_abs_err": multi_err["abs"], "max_err": multi_err["abs"],
        "max_rel_err": multi_err["rel"],
        "ms": multi_ms[f"1x{M}"], "kernel_ms": multi_ms[f"1x{M}"],
        "plain_ms": time_ms(lambda: ref.cost_eval_multi_ref(*a), 300),
        "bound_ms": 1e3 * max(multi_bytes / HBM_BYTES_PER_S,
                              multi_ops / FP32_FLOP_PER_S),
        "bound_by": ("bytes" if multi_bytes / HBM_BYTES_PER_S
                     >= multi_ops / FP32_FLOP_PER_S else "operations"),
        "library_ms": None, "ms_by_shape": multi_ms}
    return [cost_entry, lstm_entry, multi_entry]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="",
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        import torch

        card = phase_device()
        dev = torch.device("cuda", 0)
        from repro_torch.core import env as env_lib
        env_lib.resolve_device(dev)     # float32 products, TF32 off
        build_s = phase_build()
        cost_err = phase_cost_kernel(dev)
        multi_err = phase_multi_kernel(dev)
        lstm_err = phase_lstm_kernel(dev)
        counts, timing = phase_main_path(EPOCHS, GA_GENERATIONS)
        service_counts, service = phase_service(dev)
        kernels = phase_timings(dev, counts, cost_err, lstm_err,
                                service_counts, multi_err)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": kernels}))
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "main_path": timing,
             "service_path": service, "service_launches": service_counts,
             "kernels": kernels, **result}, indent=1))
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
