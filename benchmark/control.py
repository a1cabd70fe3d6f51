"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and its control's.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 1 [--control bf16x3]

Runs the cell once per seed in one process, at the cell's own size and
load, and prints each run's compared numbers (and its end-to-end
metrics) and one JSON line with all of them. Without ``--control`` the
timed path is the program's (the lower readings); with it, the plain
reference at the named lower precision stands in the program's place
(the upper readings). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", choices=("bf16x3",), default=None)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(run.ROOT), args.workload)
    run.accelerator(cell.chips)
    run.configure_jax()
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run.run_cell(cell, seed, args.seconds, False,
                              control=args.control,
                              log=lambda s: print(s, file=sys.stderr))
        numbers = {k: v["value"] for k, v in result["checks"].items()}
        rates = {k: v["value"] for k, v in result["metrics"].items()}
        readings.append({"seed": seed, "correct": result["correct"],
                         "failed": result["failed"], **numbers, **rates})
        print(f"{args.workload} control={args.control} seed={seed} "
              f"correct={result['correct']} {numbers} {rates}", flush=True)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
