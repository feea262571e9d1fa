"""The kernel selftest's command line: every CUDA kernel of the package
against its plain version on the card, each check isolated, one JSON line.

Port of the JAX package's ``tools/kernel_selftest.py``, over
``rpo_tpu_torch.ops.selftest.run_selftest``:

    python -m rpo_tpu_torch.tools.kernel_selftest [--tol 2e-2] [--retries 1] [--quiet]

It builds the CUDA sources first (``ops/_build.py``, one nvcc each, into
``build/``), then runs the table.  It exits 0 only if every check passes,
and never stops at the first fault.  Without a card it exits 1 with
``resolve_device``'s message and prints no result line: a skipped run
(the JAX tool's exit 0 on a host without its accelerator) would read as a
pass here.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tol", type=float, default=2e-2,
                   help="the bound of the bf16 comparisons (max abs error)")
    p.add_argument("--retries", type=int, default=1,
                   help="retries of a check that raised an exception other than a CUDA error")
    p.add_argument("--quiet", action="store_true", help="no per-check lines on stderr")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..ops import _build
    from ..ops.selftest import run_selftest

    try:
        device = resolve_device()
    except RuntimeError as exc:
        print(f"kernel_selftest: {exc}", file=sys.stderr)
        return 1
    build_s, _ = _build.build_all()
    out = run_selftest(args.tol, args.retries, verbose=not args.quiet, device=device)
    out["build_seconds"] = round(build_s, 1)
    print(json.dumps(out), flush=True)
    return 0 if out["value"] == out["total"] else 1


if __name__ == "__main__":
    sys.exit(main())
