#!/usr/bin/env python3
"""Host time of the search path's kernel calls on one NVIDIA card.

    python3 tools/profile_search_kernels.py               # this checkout
    python3 tools/profile_search_kernels.py --compare _archive/parent/src

Without ``--compare`` it prints one JSON line: the host ns per call of
each piece of this checkout's cost-kernel and LSTM wrappers (checks,
allocation, stream query, the packed arguments and the ctypes call with
nothing to launch, the views that ``LSTMCellFn`` makes) and of the whole
calls at the search path's shapes,
each timed alone with ``time.perf_counter_ns`` over back-to-back calls.

With ``--compare OTHER_SRC`` it times the search path's calls
(``chip_smoke.search_kernel_calls``, the LSTM backward's wrapper among
them), the service's (:func:`service_kernel_calls`: the per-row kernel's
wrapper on contiguous inputs, and where the tree reads them in place on
the service's (M, 11) rows, and the batcher's ``eval_point_rows``, at
M = 53, 5,300 and 27,136) and a stage-1 epoch
(``chip_smoke.stage1_epoch_calls``: a replay of
the captured epoch where the tree has one, else its eager epoch) of
another tree of the port, such as a ``git archive`` of a parent commit
unpacked under the git-ignored ``_archive/``, and of this checkout in one
process, in turns (other, this, this, other, twice): the host of the
machine with the card is noisy from process to process, so only calls
timed side by side compare.  Besides the mean, each run's host time per
call gets its median, 99th percentile and maximum over the calls, and
the Python garbage collections that ran during it.  Each call also gets
its device µs per launch of its kernel (the epoch: of the LSTM backward)
from two profiler traces a tree, also taken in turns (other, this, this,
other).

With ``--flash --compare OTHER_SRC`` it times flash decode's three
wrappers instead (:func:`flash_decode_calls`: ``flash_decode`` at phase
9's shapes, ``flash_decode_partials`` and ``flash_decode_combine`` at phase
8d's), the same way.

With ``--service`` it runs phase 7's service requests instead (serially
once per tree, as a warm-up; then through the service, once unprobed and
once under ``chip_smoke.DispatchProbe``), ``--rounds`` times, and prints
each run's seconds and dispatch split; with ``--compare`` too, on both
trees in turns (other, this, this, other, ...).

Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from array import array
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ns_per_call(fn, iters=2000, warmup=50):
    warmup = min(warmup, iters)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    return (time.perf_counter_ns() - t0) / iters


def host_profile(dev):
    """ns per call of each piece of this checkout's wrappers, timed alone,
    and of the whole calls."""
    import torch

    import chip_smoke
    from repro_torch.kernels import build, costmodel_eval, lstm_cell

    B, N = 20, 53
    calls = chip_smoke.search_kernel_calls(dev)
    lt = torch.ones((8, N), device=dev)
    pe = torch.ones((B, N), device=dev)
    x, h, c, wx, wh, b = chip_smoke._lstm_inputs(1, 10, 128, dev, seed=7)
    out7 = torch.empty((7, 1, 128), device=dev)
    cost_launch = costmodel_eval._launcher()
    lstm_launch = lstm_cell._launcher()
    pieces = {
        "check_inputs, one tensor": lambda: build.check_inputs(
            (pe,), ("pe",), ((B, N),)),
        "check_inputs, the LSTM step's six tensors": lambda: (
            build.check_inputs((x, h, c, wx, wh, b), lstm_cell._NAMES,
                               ((1, 10), (1, 128), (1, 128), (10, 512),
                                (128, 512), (512,)))),
        "broadcast_strides, one operand": lambda: (
            costmodel_eval.broadcast_strides(pe.shape, pe.stride(), B, N,
                                             "pe")),
        "new_empty((4, B, N))": lambda: lt.new_empty((4, B, N)),
        "build.stream": lambda: build.stream(dev.index),
        # B = 0: the library returns before any CUDA call, so these are
        # the packing of the launch arguments and the ctypes call alone.
        "cost_eval arguments packed + ctypes call, nothing launched":
            lambda: cost_launch(
                array("q", (lt.data_ptr(), pe.data_ptr(), N, 1, pe.data_ptr(),
                            N, 1, 0, 0, 0, pe.data_ptr(), 0, N)
                      ).buffer_info()[0],
                array("f", (0.0, 0.0, 0.0)).buffer_info()[0], dev.index, 0),
        "lstm_cell arguments packed + ctypes call, nothing launched":
            lambda: lstm_launch(array("q", (
                x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
                wh.data_ptr(), b.data_ptr(), out7.data_ptr(), 0, 10, 128)
            ).buffer_info()[0], dev.index, 0),
        "LSTMCellFn's views out[0], out[1]": lambda: (out7[0], out7[1]),
    }
    for name, (fn, _, _) in calls.items():
        pieces[f"whole call: {name}"] = fn
    res = {}
    for name, fn in pieces.items():
        res[name] = _ns_per_call(fn)
        torch.cuda.synchronize()
    return res


def _host_runs(fn, iters, warmup=20):
    """Host ns of each of ``iters`` calls of ``fn`` after ``warmup``:
    their mean, median, 99th percentile and maximum, and the garbage
    collections (all generations; the oldest) that ran meanwhile."""
    for _ in range(min(warmup, iters)):
        fn()
    gens = [g["collections"] for g in gc.get_stats()]
    ns = []
    clock = time.perf_counter_ns
    for _ in range(iters):
        t0 = clock()
        fn()
        ns.append(clock() - t0)
    after = [g["collections"] for g in gc.get_stats()]
    ns.sort()
    return {"mean": sum(ns) / iters, "median": ns[iters // 2],
            "p99": ns[int(0.99 * (iters - 1))], "max": ns[-1],
            "gc": sum(after) - sum(gens), "gc_oldest": after[-1] - gens[-1]}


def service_kernel_calls(dev):
    """The search service's kernel calls (name -> (fn, kernel name,
    CUDA-event iterations)) at each of ``chip_smoke.MULTI_SHAPES``: the
    per-row kernel's wrapper on contiguous (M, 8) and (M,) inputs, on the
    columns of the same points packed as (M, 11) rows where the tree's
    wrapper reads them in place (a tree whose batcher has ``_DeviceIO``),
    and the batcher's ``eval_point_rows`` on those rows as numpy (an
    upload, the kernel, a download and a wait: the event time is the
    host's; with one ``_DeviceIO`` kept across calls, as a dispatcher
    thread keeps it, where the tree has one)."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.costmodel import layers as layers_lib
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import costmodel_eval
    from repro_torch.serving import batcher

    arr = layers_lib.layers_to_array(workloads.get_workload("mobilenet_v2"))
    rng = np.random.default_rng(3)
    in_place = hasattr(batcher, "_DeviceIO")
    io = (batcher._DeviceIO(dev),) if in_place else ()
    kernel = "cost_eval_multi_kernel"
    out = {}
    for M in chip_smoke.MULTI_SHAPES:
        a = chip_smoke._flat_points(arr, M, rng, dev)
        rows = torch.cat([a[0], *(v[:, None] for v in a[1:])], 1)
        out[f"cost_eval_multi 1x{M}"] = (
            lambda a=a: costmodel_eval.cost_eval_multi(*a), kernel, 2000)
        if in_place:
            cols = (rows[:, :8], rows[:, 8], rows[:, 9], rows[:, 10])
            out[f"cost_eval_multi (M, 11) rows 1x{M}"] = (
                lambda c=cols: costmodel_eval.cost_eval_multi(*c), kernel,
                2000)
        host = rows.cpu().numpy()
        out[f"eval_point_rows 1x{M}"] = (
            lambda r=host: batcher.eval_point_rows(r, dev, *io), kernel, 300)
    return out


def flash_decode_calls(dev):
    """Flash decode's wrappers (name -> (fn, kernel name, CUDA-event
    iterations)): ``flash_decode`` at ``chip_smoke.FLASH_TIMED``'s bf16
    shapes, and at each of ``chip_smoke.SHARD_TIMED`` a rank's
    ``flash_decode_partials`` of its valid rows at the shard width and
    ``flash_decode_combine`` of the partials padded to it, m ranks' side
    by side (phase 8d's calls)."""
    import torch

    import chip_smoke
    from repro_torch.kernels import flash_decode, ref

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for shape, dt_name in chip_smoke.FLASH_TIMED:
        if dt_name != "bfloat16":
            continue
        q, k, v = chip_smoke._attn_inputs(shape, torch.bfloat16, dev, 41)
        out[f"flash_decode {list(shape)} bf16"] = (
            lambda q=q, k=k, v=v: flash_decode.flash_decode(q, k, v),
            "flash_decode_split_kernel", 500)
    for (B, Hq, Hkv, D, T), m, n, dt_name in chip_smoke.SHARD_TIMED:
        dt = getattr(torch, dt_name)
        width = flash_decode.shard_width(m, T // m)
        S = flash_decode.plan_splits(B, Hkv, n, sms, width)[0]
        q, k, v = chip_smoke._attn_inputs((B, Hq, Hkv, D, n), dt, dev, 43)
        key = f"{[B, Hq, Hkv, D, n]} m={m} {dt_name}"
        out[f"flash_decode_partials {key}"] = (
            lambda q=q, k=k, v=v, w=width:
            flash_decode.flash_decode_partials(q, k, v, w),
            "flash_decode_split_kernel", 2000)
        parts = torch.cat([flash_decode.flash_decode_partials(
            q, k, v, width), ref.neutral_partials(B, Hq, width - S, D,
                                                  dev)] * m, dim=2)
        out[f"flash_decode_combine {list(parts.shape)}"] = (
            lambda p=parts: flash_decode.flash_decode_combine(p),
            "flash_decode_combine_kernel", 2000)
    return out


def _purge_port_modules():
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]


def compare(dev, other_src, src, rounds=2, flash=False):
    """The search path's and the service's calls of two trees of the port
    in one process, timed in turns (other, this, this, other, ...
    ``rounds`` times): mean CUDA-event ms and perf_counter ns per call of
    each, and each tree's device µs per launch of the named kernel, the
    mean of two profiler traces taken in turns.
    ``other_src`` is imported first; its modules stay alive in the calls'
    closures after ``src`` replaces them in ``sys.modules``.  With
    ``flash``, flash decode's wrappers instead (:func:`flash_decode_calls`).
    """
    import chip_smoke

    trees = {}
    for label, path in (("other", other_src), ("this", src)):
        _purge_port_modules()
        sys.path.insert(0, str(Path(path).resolve()))
        if flash:
            trees[label] = flash_decode_calls(dev)
        else:
            trees[label] = {**chip_smoke.search_kernel_calls(dev),
                            **service_kernel_calls(dev)}
            epoch = chip_smoke.stage1_epoch_calls(dev)[0]
            trees[label]["stage1 epoch"] = (
                epoch.get("graphed", epoch["eager"]),
                chip_smoke.LSTM_BWD_KERNEL, 20)
        sys.path.pop(0)
    out = {}
    for name in trees["this"]:
        labels = [lb for lb in ("other", "this") if name in trees[lb]]
        turns = [lb for lb in ("other", "this", "this", "other")
                 if lb in labels]
        ms = {lb: [] for lb in labels}
        host = {lb: [] for lb in labels}
        for _ in range(rounds):
            for label in turns:
                fn, _, iters = trees[label][name]
                ms[label].append(chip_smoke.time_ms(fn, iters))
                host[label].append(_host_runs(fn, iters))
        traces = {lb: [] for lb in labels}
        for label in turns:
            fn, kernel, iters = trees[label][name]
            traces[label].append(chip_smoke._kernel_trace(
                fn, min(chip_smoke.SEARCH_TRACE_CALLS, iters)))
        row = {}
        for label in labels:
            kernel = trees[label][name][1]
            us = [chip_smoke._per_launch_us(t, kernel)[0]
                  for t in traces[label]]
            row[label] = {
                "ms": sum(ms[label]) / len(ms[label]), "ms_runs": ms[label],
                "host_ns": sum(h["mean"] for h in host[label])
                / len(host[label]),
                "host_ns_runs": host[label],
                "kernel_device_us_per_launch": (
                    None if None in us else sum(us) / len(us)),
                "kernel_device_us_runs": us,
                "device_us_per_call": traces[label][0]["device_us_per_call"],
                "launches_per_call": traces[label][0]["launches_per_call"]}
        if len(labels) == 2:
            row["ms_ratio_this_over_other"] = (row["this"]["ms"]
                                               / row["other"]["ms"])
        out[name] = row
    return out


def _probe_for(batcher):
    """``chip_smoke.DispatchProbe`` for a tree whose batcher aggregates
    each item on its own (``aggregate_point_values``, before the dispatch
    aggregated all items at once), else the probe itself."""
    import chip_smoke

    if hasattr(batcher, "aggregate_items"):
        return chip_smoke.DispatchProbe()

    class Probe(chip_smoke.DispatchProbe):
        AGG_NAME = "aggregate_point_values"
    return Probe()


def service(dev, trees, rounds):
    """Phase 7's service requests on each of ``trees`` (label -> src
    directory): serially once per tree (the kernels' first calls), then,
    in turns ``rounds`` times, through the service unprobed and under the
    dispatch probe: each run's seconds and dispatch split."""
    import torch

    import chip_smoke

    def use(label):
        _purge_port_modules()
        sys.path.insert(0, str(Path(trees[label]).resolve()))
        from repro_torch.serving import batcher
        sys.path.pop(0)
        return batcher

    specs = chip_smoke.SERVICE_REQUESTS
    out = {label: {"runs": []} for label in trees}
    for label in trees:
        use(label)
        from repro_torch import api
        t0 = time.perf_counter()
        for r in chip_smoke._service_requests(specs):
            api.run_search(r)
        torch.cuda.synchronize()
        out[label]["serial_s"] = time.perf_counter() - t0
    order = list(trees) + list(trees)[::-1]
    for _ in range(rounds):
        for label in order if len(trees) > 1 else list(trees):
            batcher = use(label)
            _, _, stats, service_s = chip_smoke.service_run(
                dev, chip_smoke._service_requests(specs))
            probe = _probe_for(batcher)
            _, _, probed_stats, probed_s = chip_smoke.service_run(
                dev, chip_smoke._service_requests(specs), probe)
            out[label]["runs"].append({
                "service_s": service_s, "dispatches": stats["dispatches"],
                "ms_per_dispatch": 1e3 * stats["dispatch_seconds"]
                / max(stats["dispatches"], 1),
                "probed_service_s": probed_s,
                "dispatch_split": probe.split(probed_s)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", default="",
                    help="another tree's src directory: time the search "
                    "path's calls of both trees in turns in this process")
    ap.add_argument("--service", action="store_true",
                    help="run phase 7's service requests, unprobed and "
                    "under the dispatch probe, instead")
    ap.add_argument("--flash", action="store_true",
                    help="with --compare: flash decode's wrappers instead")
    ap.add_argument("--rounds", type=int, default=1,
                    help="service runs per tree (with --service)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("profile_search_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # float32 products, TF32 off, as the port's entry points set them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_device()
    if args.service:
        sys.path.remove(str(ROOT / "src"))
        trees = {"this": ROOT / "src"}
        if args.compare:
            trees = {"other": args.compare, **trees}
        print(json.dumps({"service": service(dev, trees, args.rounds)}),
              flush=True)
    elif args.compare:
        sys.path.remove(str(ROOT / "src"))
        print(json.dumps({"compare": args.compare, "calls": compare(
            dev, args.compare, ROOT / "src", flash=args.flash)}),
            flush=True)
    else:
        print(json.dumps({"host_ns": host_profile(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
