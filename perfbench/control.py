"""Readings of the correctness numbers for the program and for the control.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        [--device cuda] [--fault <name>]

For each seed, one search of the cell's mix through the program; then
every number of the cell read twice over those searches: as the program
gives it, and with the reference put in the program's place in the next
precision below the configurations' float32 with TF32 off (the policy
replayed with TF32 products, the cost model in bfloat16).  With
``--fault`` the searches run with that fault of ``perfbench.faults``
planted in the program.  A limit lies above the program's readings and
below the control's and the faults'.  The benchmark's own runs do not
run this.
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from perfbench import check, faults, harness, traffic  # noqa: E402


def readings(root: Path, name: str, seeds, device: str,
             fault: str = None) -> dict:
    import torch

    cell = harness.resolve(root, name)
    sys.path.insert(0, str(root / "src"))
    from repro_torch import api

    runs = []
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        for s in seeds:
            req = traffic.request(api, cell.config, cell.traffic,
                                  traffic.search_seed(s, 0), device)
            runs.append((req, api.run_search(req)))
    out = {"workload": name, "seeds": list(seeds), "fault": fault,
           "program": {}, "control": {}}
    for run in runs:
        for side in ("program", "control"):
            nums = check.judge([run], cell.config, cell.traffic,
                               torch.device(device),
                               control=side == "control")["numbers"]
            for k, v in nums.items():
                out[side].setdefault(k, []).append(v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    print(json.dumps(readings(ROOT, args.workload, seeds, args.device,
                              args.fault)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
