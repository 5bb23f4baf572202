#!/usr/bin/env python3
"""Time the flash-decode kernel's build and plan choices on one NVIDIA card.

    python3 tools/tune_flash_decode.py                       # defaults
    python3 tools/tune_flash_decode.py --stages 2,3 --blocks-per-sm 4,8

For each ring depth in ``--stages`` it builds a copy of
``src/repro_torch/kernels/csrc/flash_decode.cu`` with that many stages
(``nvcc``, all builds at once, into the git-ignored ``_build/tune/``), and
for each ``--blocks-per-sm`` it re-plans the splits
(``flash_decode.BLOCKS_PER_SM``).  Every combination is first held to
``ref.flash_decode_ref`` (atol 1e-4), then timed with CUDA events over
calls that cycle through enough input copies to miss the 50 MB L2 cache.
Prints the card and one JSON line per shape; needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STAGES_LINE = "static constexpr int kStages = 2;"


def _build_variants(stages):
    from repro_torch.kernels import build

    src = (build.CSRC / "flash_decode.cu").read_text()
    if STAGES_LINE not in src:
        raise SystemExit(f"tune_flash_decode: {STAGES_LINE!r} not in the "
                         "source; update the script")
    out = build.BUILD_DIR / "tune"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in stages:
        cu = out / f"flash_decode_s{n}.cu"
        cu.write_text(src.replace(STAGES_LINE,
                                  f"static constexpr int kStages = {n};"))
        so = cu.with_suffix(".so")
        procs[n] = (subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for n, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {n} stages:\n{log}")
        fn = ctypes.CDLL(str(so)).flash_decode_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


def _ms(fn, sets, iters):
    import torch

    for i in range(5):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default="2,3")
    ap.add_argument("--blocks-per-sm", default="4,8,12")
    ap.add_argument("--shapes", default="8x16x2x128x32768:bfloat16,"
                    "8x16x2x128x32768:float32,128x16x2x128x32768:bfloat16",
                    help="B x Hq x Hkv x D x T : dtype, comma-separated")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import flash_decode, ref

    if not torch.cuda.is_available():
        print("tune_flash_decode: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    fns = _build_variants([int(s) for s in args.stages.split(",")])
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for spec in args.shapes.split(","):
        dims, dt_name = spec.split(":")
        B, Hq, Hkv, D, T = (int(x) for x in dims.split("x"))
        dt = getattr(torch, dt_name)
        el = torch.finfo(dt).bits // 8
        nbytes = el * 2 * B * T * Hkv * D
        gen = torch.Generator(device=dev).manual_seed(0)
        f = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)
        sets = [(f(B, Hq, D), f(B, T, Hkv, D), f(B, T, Hkv, D))
                for _ in range(max(1, -(-120_000_000 // nbytes)))]
        want = ref.flash_decode_ref(*sets[0])
        res = {}
        for n, fn in fns.items():
            flash_decode._fn = fn
            for bps in (int(b) for b in args.blocks_per_sm.split(",")):
                flash_decode.BLOCKS_PER_SM = bps
                flash_decode._plans.clear()
                err = float((flash_decode.flash_decode(*sets[0])
                             - want).abs().max())
                if not err <= 1e-4:
                    raise SystemExit(f"{n} stages, {bps} blocks per SM: "
                                     f"error {err} at {spec}")
                res[f"stages={n},blocks_per_sm={bps}"] = {
                    "splits": flash_decode.plan_splits(B, Hkv, T, sms)[0],
                    "ms": _ms(flash_decode.flash_decode, sets, args.iters)}
        print(json.dumps({"shape": spec, "bound_ms": 1e3 * nbytes / 3.35e12,
                          "results": res}), flush=True)
        del sets, want
        torch.cuda.empty_cache()
    flash_decode._fn = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
