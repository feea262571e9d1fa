"""Aggregate test results from log.txt files across seed directories.

A copy of ``rpo_tpu/parse_results.py`` (the port imports nothing of the
JAX package), for the logs the port's CLI writes:

    python -m rpo_tpu_torch.parse_results output/base2new/test_new/... [--ci95]

It walks seed subdirectories, scrapes ``* <keyword>: X%`` lines that
come after the end signal (``Finish training``, or ``=> result`` with
--test-log), and prints per-seed values and mean +- std (or CI95); with
--multi-exp it aggregates nested layouts.  --hmean: given directories
whose names end in base/new (the base-to-new protocol's layout), it also
prints the harmonic mean H = 2*base*new/(base+new).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import re
from collections import OrderedDict, defaultdict

import numpy as np


def listdir_nohidden(path, sort=False):
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items


def compute_ci95(values) -> float:
    return 1.96 * np.std(values) / np.sqrt(len(values))


def parse_dir(directory: str, keyword: str, end_signal: str, ci95: bool,
              strict: bool = True):
    """strict=True asserts every seed subdir has a log.txt (the reference
    tool's behavior); strict=False (the --hmean walk) warns and skips
    in-progress seed dirs that exist but haven't produced a log yet."""
    regex = re.compile(rf"\* {keyword}: ([\.\deE+-]+)%")
    print(f"Parsing files in {directory}")
    outputs = []
    for subdir in listdir_nohidden(directory, sort=True):
        fpath = osp.join(directory, subdir, "log.txt")
        if not osp.isfile(fpath):
            assert not strict, f"Missing {fpath}"
            print(f"(!) skipping {osp.join(directory, subdir)}: no log.txt yet")
            continue
        good_to_go = False
        output = OrderedDict()
        with open(fpath) as f:
            for line in f:
                line = line.strip()
                if line == end_signal:
                    good_to_go = True
                match = regex.search(line)
                if match and good_to_go:
                    output.setdefault("file", fpath)
                    output[keyword] = float(match.group(1))
        if output:
            outputs.append(output)
    if not outputs and not strict:
        # every seed log exists but none has reached the end signal yet
        print(f"(!) skipping {directory}: no completed runs yet")
        return OrderedDict()
    assert len(outputs) > 0, f"Nothing found in {directory}"

    metrics_results = defaultdict(list)
    for output in outputs:
        msg = ""
        for key, value in output.items():
            msg += f"{key}: {value:.2f}%. " if isinstance(value, float) else f"{key}: {value}. "
            if key != "file":
                metrics_results[key].append(value)
        print(msg)

    results = OrderedDict()
    print("===")
    print(f"Summary of directory: {directory}")
    for key, values in metrics_results.items():
        avg = np.mean(values)
        spread = compute_ci95(values) if ci95 else np.std(values)
        print(f"* {key}: {avg:.2f}% +- {spread:.2f}%")
        results[key] = avg
    print("===")
    return results


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("directory", type=str, help="path to directory")
    parser.add_argument("--ci95", action="store_true", help="compute 95%% confidence interval")
    parser.add_argument("--test-log", action="store_true", help="parse test-only logs")
    parser.add_argument("--multi-exp", action="store_true", help="parse multiple experiments")
    parser.add_argument("--keyword", default="accuracy", type=str, help="keyword to extract")
    parser.add_argument(
        "--hmean", action="store_true",
        help="also print harmonic mean over sub-experiments named */base and */new",
    )
    args = parser.parse_args()

    end_signal = "=> result" if args.test_log else "Finish training"

    if args.multi_exp:
        final_results = defaultdict(list)
        for sub in listdir_nohidden(args.directory, sort=True):
            directory = osp.join(args.directory, sub)
            results = parse_dir(directory, args.keyword, end_signal, args.ci95)
            for key, value in results.items():
                final_results[key].append(value)
        print("Average performance")
        for key, values in final_results.items():
            print(f"* {key}: {np.mean(values):.2f}%")
    if args.hmean:
        # Aggregate over the test_base/test_new halves of the base-to-new
        # protocol.  Exact directory names only (a sibling train_base/
        # carries training-run accuracies that must not enter the base
        # mean), walked recursively so both the flat layout
        # (<dir>/test_base/<seed>/log.txt) and the protocol layout
        # (<dir>/test_base/<dataset>/shots_N/<trainer>/<cfg>/<seed>/log.txt)
        # work.
        def _collect(kind):
            root = None
            for cand in (f"test_{kind}", kind):
                path = osp.join(args.directory, cand)
                if osp.isdir(path):
                    root = path
                    break
            if root is None:
                return []
            vals = []
            for dirpath, dirnames, _files in os.walk(root):
                # a leaf experiment dir: its children are seed dirs
                if any(
                    osp.isfile(osp.join(dirpath, d, "log.txt")) for d in dirnames
                ):
                    # non-strict: an in-progress seed dir (created, no log
                    # yet) is skipped with a warning, not an AssertionError.
                    # test_base/test_new are eval-only runs by construction,
                    # so their end signal is always "=> result" — with the
                    # train-log default every leaf would read as incomplete.
                    res = parse_dir(dirpath, args.keyword, "=> result",
                                    args.ci95, strict=False)
                    if args.keyword in res:
                        vals.append(res[args.keyword])
                    dirnames[:] = []  # a leaf has no nested experiments —
                    # don't descend into seed dirs (double-count guard)
            return vals

        base = _collect("base")
        new = _collect("new")
        if base and new:
            b, n = np.mean(base), np.mean(new)
            print(f"* harmonic mean (H): {2 * b * n / (b + n):.2f}%")
        else:
            print("(!) --hmean: no test_base and test_new sub-experiments found")
    if not args.multi_exp and not args.hmean:
        parse_dir(args.directory, args.keyword, end_signal, args.ci95)


if __name__ == "__main__":
    main()
