"""Run one cell of ``BENCHMARK.json``:

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs as many CUDA cards as the cell asks
for, prints the cell's numbers compared to decide ``correct`` on standard
error (last), and one JSON object as the last line of standard output.
"""
from __future__ import annotations

import time

#: set-up counts from here, the imports of torch and the program included
T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           device="cuda:0", t_start=T_START)
    bad = harness.banned_modules()
    if bad:
        print(f"perfbench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
