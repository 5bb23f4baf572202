"""Run one cell of the port's benchmark on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the last line of
standard output is the result with the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, from the window's telemetry spans and
a profiled slice of one more search.  Either way every search the run
made is judged against the plain references, and the numbers compared,
each with its limit, are the last lines of standard error and the last
key of the result.  Without a card (or with fewer than the cell asks for)
it exits 2 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# One process with few threads: the host's work is Python and launches,
# and idle OpenMP workers spinning beside it only add noise.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
# The checkout's root, not this directory, leads the import path.  The
# port builds its kernels into its own src/repro_torch/kernels/_build/,
# inside the checkout; no other build or kernel cache is used.
sys.path[0] = str(ROOT)

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = harness.resolve(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port must not load JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
