#!/usr/bin/env python3
"""Time the per-row cost kernel's block size on one NVIDIA card.

    python3 tools/tune_cost_multi.py                  # 32 ... 512 threads
    python3 tools/tune_cost_multi.py --threads 64,128 --shapes 5300

The wrapper ``costmodel_eval.cost_eval_multi`` passes the library its
module constant ``MULTI_THREADS`` as the block size; the tool sets that
constant for each variant in turn, so one build serves every variant.  At
each shape (1, M) of ``--shapes`` (by default
``chip_smoke.MULTI_SHAPES``: an sa step, a GA generation, a random-search
batch on mobilenet_v2) the kernel runs in two forms: as the search
service calls it (``rows``: the layer fields and pe / kt / df read in
place from one (M, 11) block of packed rows) and on contiguous (M, 8)
and (M,) inputs (``contiguous``).  Every variant must give the bits of
the default; then each is timed in turns (CUDA-event ms per call over
2000 calls, twice in the order given and twice reversed) and gets its
device µs per launch from two profiler traces of 200 calls, also taken
in turns.  Prints the card and one JSON line; needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="32,64,128,256,512")
    ap.add_argument("--shapes", default="")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.costmodel import layers as layers_lib
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import costmodel_eval

    if not torch.cuda.is_available():
        print("tune_cost_multi: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    chip_smoke.phase_device()
    threads = [int(t) for t in args.threads.split(",")]
    shapes = ([int(m) for m in args.shapes.split(",")] if args.shapes
              else list(chip_smoke.MULTI_SHAPES))
    arr = layers_lib.layers_to_array(workloads.get_workload("mobilenet_v2"))
    rng = np.random.default_rng(3)
    default = costmodel_eval.MULTI_THREADS
    out = {"default_threads": default, "by_shape": {}}
    for M in shapes:
        a = chip_smoke._flat_points(arr, M, rng, dev)
        rows = torch.cat([a[0], *(v[:, None] for v in a[1:])], 1)
        forms = {"rows": (rows[:, :8], rows[:, 8], rows[:, 9],
                          rows[:, 10]),
                 "contiguous": a}
        for form, args_ in forms.items():
            def call(t, args_=args_):
                costmodel_eval.MULTI_THREADS = t
                try:
                    return costmodel_eval.cost_eval_multi(*args_)
                finally:
                    costmodel_eval.MULTI_THREADS = default
            calls = {t: (lambda t=t: call(t)) for t in threads}
            want = call(default)
            for t, fn in calls.items():
                if not torch.equal(fn(), want):
                    raise SystemExit(f"tune_cost_multi: {t} threads per "
                                     f"block differ from the default at "
                                     f"M = {M} ({form})")
            ms = {t: [] for t in threads}
            us = {t: [] for t in threads}
            for order in (threads, threads[::-1], threads, threads[::-1]):
                for t in order:
                    ms[t].append(chip_smoke.time_ms(calls[t], 2000))
            for order in (threads, threads[::-1]):
                for t in order:
                    trace = chip_smoke._kernel_trace(
                        calls[t], chip_smoke.SEARCH_TRACE_CALLS)
                    us[t].append(chip_smoke._per_launch_us(
                        trace, "cost_eval_multi_kernel")[0])
            out["by_shape"].setdefault(M, {})[form] = {
                t: {"ms": sum(ms[t]) / len(ms[t]), "ms_runs": ms[t],
                    "blocks": -(-M // t),
                    "device_us_per_launch": sum(us[t]) / len(us[t]),
                    "device_us_runs": us[t]} for t in threads}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
