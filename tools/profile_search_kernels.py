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
them) and a stage-1 epoch (``chip_smoke.stage1_epoch_calls``: a replay of
the captured epoch where the tree has one, else its eager epoch) of
another tree of the port, such as a ``git archive`` of a parent commit
unpacked under the git-ignored ``_archive/``, and of this checkout in one
process, in turns (other, this, this, other, twice): the host of the
machine with the card is noisy from process to process, so only calls
timed side by side compare.  Each call also gets its device µs per
launch of its kernel (the epoch: of the LSTM backward) from one profiler
trace.

Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
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


def _purge_port_modules():
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]


def compare(dev, other_src, src, rounds=2):
    """The search path's calls of two trees of the port in one process,
    timed in turns (other, this, this, other, ... ``rounds`` times): mean
    CUDA-event ms and perf_counter ns per call of each, and each tree's
    device µs per launch of the named kernel from one profiler trace.
    ``other_src`` is imported first; its modules stay alive in the calls'
    closures after ``src`` replaces them in ``sys.modules``."""
    import chip_smoke

    trees = {}
    for label, path in (("other", other_src), ("this", src)):
        _purge_port_modules()
        sys.path.insert(0, str(Path(path).resolve()))
        trees[label] = chip_smoke.search_kernel_calls(dev)
        epoch = chip_smoke.stage1_epoch_calls(dev)[0]
        trees[label]["stage1 epoch"] = (
            epoch.get("graphed", epoch["eager"]),
            chip_smoke.LSTM_BWD_KERNEL, 20)
        sys.path.pop(0)
    out = {}
    for name in trees["this"]:
        ms = {"other": [], "this": []}
        ns = {"other": [], "this": []}
        for _ in range(rounds):
            for label in ("other", "this", "this", "other"):
                fn, _, iters = trees[label][name]
                ms[label].append(chip_smoke.time_ms(fn, iters))
                ns[label].append(_ns_per_call(fn, iters))
        row = {}
        for label in ("other", "this"):
            fn, kernel, iters = trees[label][name]
            trace = chip_smoke._kernel_trace(
                fn, min(chip_smoke.SEARCH_TRACE_CALLS, iters))
            row[label] = {
                "ms": sum(ms[label]) / len(ms[label]), "ms_runs": ms[label],
                "host_ns": sum(ns[label]) / len(ns[label]),
                "kernel_device_us_per_launch":
                    chip_smoke._per_launch_us(trace, kernel)[0],
                "device_us_per_call": trace["device_us_per_call"],
                "launches_per_call": trace["launches_per_call"]}
        row["ms_ratio_this_over_other"] = row["this"]["ms"] / row["other"][
            "ms"]
        out[name] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", default="",
                    help="another tree's src directory: time the search "
                    "path's calls of both trees in turns in this process")
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
    if args.compare:
        sys.path.remove(str(ROOT / "src"))
        print(json.dumps({"compare": args.compare, "calls": compare(
            dev, args.compare, ROOT / "src")}), flush=True)
    else:
        print(json.dumps({"host_ns": host_profile(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
