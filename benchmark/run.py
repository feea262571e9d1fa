"""The benchmark of ``rpo_tpu_torch`` on the card: one run of one cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
directory and the ``rpo_tpu_torch`` package.  It prints one JSON object as
the last line of its standard output (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, ``busy_s``,
``window_s`` and a ``breakdown``), and the numbers compared, each beside
its limit, as the last lines of its standard error.  It exits non-zero,
and prints no result, without a CUDA card, without the program, or if a
module of the JAX package or of JAX is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a build or a kernel compiler might keep: fixed, in the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "benchmark" / sub)

    from benchmark.spec import Spec

    spec = Spec(ROOT)
    try:
        workload = spec.workload(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    try:
        import rpo_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is not here: {e}", file=sys.stderr)
        return 2
    from benchmark.harness import forbidden_modules, load_cell, run_cell

    cell = load_cell(spec, args.workload, args.seed, "cuda")
    result = run_cell(spec, cell, args.seconds, bool(args.trace), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port may not use JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
