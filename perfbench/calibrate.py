"""The readings that limits are set from, on the card, in one process:

    python3 -m perfbench.calibrate --workload <name> --first <seed> --seeds 12 \
        --control-seeds 3 --seconds 2

For each of ``--seeds`` consecutive seeds from ``--first`` it runs the cell
(data, index, a short window at the cell's own load) and prints one JSON
line: the program's readings of every number compared and, for the first
``--control-seeds`` seeds, the control's (see ``perfbench/check.py``).
``--fault <name>`` plants a fault of ``perfbench/faults.py`` in the
program first; ``--data key=value`` changes a parameter of the
configuration's generator (how the cell's numbers move with the data).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from perfbench import faults, harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=sorted(faults.PLANTED))
    ap.add_argument("--data", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for kv in args.data:
        key, value = kv.split("=", 1)
        cell.config["data"] = {**cell.config["data"], key: json.loads(value)}
    if args.fault:
        faults.plant(args.fault)
    for n in range(args.seeds):
        seed = args.first + n
        out = harness.run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                               device="cuda:0", control=n < args.control_seeds)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "data": cell.config["data"], "correct": out["correct"],
                "program": {k: v["value"] for k, v in out["check"].items()},
                "control": out.get("control"), "metrics": out["metrics"],
                "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
