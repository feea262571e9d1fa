"""Readings for the limits on the numbers compared: the program's and the
control's, seed after seed, in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 3 [--seconds 2] [--control]
        [--fault unchanged|half_batch|label|answer]

Each seed is a whole run of the cell as ``benchmark.run`` makes it (set-up,
a window of ``--seconds``, the check); ``--control`` adds the numbers of
the reference computed in the control's precision, float8, in the
program's place.  One JSON line a seed: ``checks`` (the program's) and
``checks_control``, each number beside the cell's current limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark.faults import planted
    from benchmark.harness import load_cell, run_cell
    from benchmark.run import ROOT
    from benchmark.spec import Spec

    spec = Spec(ROOT)
    for seed in args.seeds:
        t0 = time.time()
        cell = load_cell(spec, args.workload, seed, "cuda")
        if args.fault:
            cell.method = planted(cell.method, args.fault)
        r = run_cell(spec, cell, args.seconds, False, t0, control=args.control)
        line = {"workload": args.workload, "fault": args.fault, "seed": seed,
                "correct": r["correct"],
                "seconds": time.time() - t0, "metrics": r["metrics"], "checks": r["checks"]}
        if args.control:
            line["checks_control"] = r["checks_control"]
        print(json.dumps(line), flush=True)
        del cell, r
    return 0


if __name__ == "__main__":
    sys.exit(main())
