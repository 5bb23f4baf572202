#!/usr/bin/env python3
"""Time the single-pass LSTM backward's rows per block on one NVIDIA card.

    python3 tools/tune_lstm_bwd.py                     # rows 1, 2, 4, 8
    python3 tools/tune_lstm_bwd.py --rows 2,4 --shape 1,10,128

For each value in ``--rows`` it builds a copy of
``src/repro_torch/kernels/csrc/lstm_cell.cu`` with that many weight rows
per block (``kUntiledRows``; ``nvcc``, all builds at once, into the
git-ignored ``_build/tune/``).  Each variant's backward, on its single
pass, and the tiled kernel once, are first held to
``ref.lstm_cell_bwd_saved_ref`` (atol 1e-5), then timed through the
port's wrapper at ``--shape`` (B, I, H): CUDA-event ms per call, in turns
over the variants, and device µs per launch from a profiler trace of 200
calls.  Prints the card and one JSON line; needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ROWS_LINE = "constexpr int kUntiledRows = 1;"


def _build_variants(rows):
    from repro_torch.kernels import build

    src = (build.CSRC / "lstm_cell.cu").read_text()
    if ROWS_LINE not in src:
        raise SystemExit(f"tune_lstm_bwd: {ROWS_LINE!r} not in the source; "
                         "update the script")
    out = build.BUILD_DIR / "tune"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for r in rows:
        cu = out / f"lstm_cell_r{r}.cu"
        cu.write_text(src.replace(ROWS_LINE,
                                  f"constexpr int kUntiledRows = {r};"))
        so = cu.with_suffix(".so")
        procs[r] = (subprocess.Popen(
            [build._nvcc(), *build._flags("lstm_cell"), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    fns = {}
    for r, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {r} rows:\n{log}")
        fn = ctypes.CDLL(str(so)).lstm_cell_bwd_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[r] = fn
    return fns


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="1,2,4,8",
                    help="weight rows per block to try")
    ap.add_argument("--shape", default="1,10,128", help="B,I,H")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke
    from repro_torch.kernels import lstm_cell, ref

    if not torch.cuda.is_available():
        print("tune_lstm_bwd: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    chip_smoke.phase_device()
    rows = [int(r) for r in args.rows.split(",")]
    B, I, H = (int(v) for v in args.shape.split(","))
    fns = _build_variants(rows)
    x, h, c, wx, wh, b = chip_smoke._lstm_inputs(B, I, H, dev, seed=7)
    gates = lstm_cell.lstm_cell(x, h, c, wx, wh, b)[2:]
    gen = torch.Generator(device=dev).manual_seed(8)
    dh, dc = (torch.randn((B, H), generator=gen, device=dev)
              for _ in range(2))
    inputs = (x, h, c, wx, wh, gates, dh, dc)
    want = ref.lstm_cell_bwd_saved_ref(*inputs)
    # Each variant's single pass, and the tiled kernel (the same in every
    # variant) once.
    variants = [(f"rows {r}", fn, False) for r, fn in fns.items()]
    variants.append(("tiled", fns[rows[0]], True))
    calls = {}
    for name, fn, tiled in variants:
        def call(fn=fn, tiled=tiled):
            # The wrapper launches through the variant's library.
            lstm_cell._bwd_fn = fn
            return lstm_cell.lstm_cell_bwd(*inputs, tiled=tiled)
        err = max(float((g - w).abs().max()) for g, w in zip(call(), want))
        if err > 1e-5:
            raise SystemExit(f"{name}: max abs err {err}")
        calls[name] = call
    ms = {name: [] for name in calls}
    for _ in range(args.rounds):
        for name, call in calls.items():
            ms[name].append(chip_smoke.time_ms(call, 2000))
    out = {}
    for name, call in calls.items():
        trace = chip_smoke._kernel_trace(call, chip_smoke.SEARCH_TRACE_CALLS)
        if trace is None:
            raise SystemExit(f"{name}: the profiler trace shows no device "
                             "time")
        out[name] = {
            "ms": sum(ms[name]) / len(ms[name]), "ms_runs": ms[name],
            "device_us_per_launch": chip_smoke._per_launch_us(
                trace, chip_smoke.LSTM_BWD_KERNEL)[0]}
    print(json.dumps({"shape": [B, I, H], "blocks": {
        r: -(-(I + H + 1) // r) for r in rows}, "variants": out}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
