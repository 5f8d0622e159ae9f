"""The control: the plain reference a precision below the configuration's
(float32 with every matrix product's operands rounded to TF32), put in
the program's place in a whole run of a cell, judged as the program is.

    python -m benchmark.control --workload <name> --seeds <n> [<n> ...] --seconds <s>

Prints one JSON line per seed with the numbers compared; the smallest
``gap_ratio`` over the seeds is the upper reading the cell's limit is set
below. It runs on the card at the cell's own batch, in one process for
all the seeds. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import time


def control_run(workload: str, seed: int, seconds: float):
    """One run of ``workload`` on the card with the control in the
    program's place."""
    from benchmark import fleets
    from benchmark.run import load_cell, run

    cell = load_cell(workload)
    fleet = fleets.ControlFleet(cell.cfg, "cuda")
    return run(cell, seed, seconds, False, fleet=fleet, t_start=time.time())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        out = control_run(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "ticks": out["ticks"],
                          "checks": out["checks"], "ratios": out["ratios"],
                          "phases": out["phases"]}), flush=True)


if __name__ == "__main__":
    main()
