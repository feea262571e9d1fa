"""Sweep runner: the protocol's independent jobs through the port's CLI.

Port of the JAX package's ``scripts/sweep.py``.  The reference fans out
(dataset, seed, shot) jobs one after another in bash, one GPU a run
(``scripts/rpo/base2new_generalization_main.sh``); this runner gives

  - the job matrix (datasets x seeds x shots) of the base-to-new protocol:
    a train job on the base classes, then a test job each on base and new;
  - N concurrent jobs on this host (``--workers``), or the i-th of M
    shards of the matrix (``--shard i/M``) for a host of several;
  - a job whose output directory already holds a finished log is skipped,
    as the reference scripts skip one;
  - a retry of each failed job, and a summary at the end.

Each job runs ``python -m rpo_tpu_torch.cli`` from the repository root.

    python -m rpo_tpu_torch.tools.sweep base2new --trainer RPO --cfg main_K24 \\
        --datasets caltech101 dtd --seeds 1 2 3 --shots 16 --workers 1
    python -m rpo_tpu_torch.tools.sweep base2new --shard 0/4 ...   # host 0 of 4
"""
from __future__ import annotations

import argparse
import glob
import itertools
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B2N_DATASETS = [
    "eurosat", "dtd", "fgvc_aircraft", "oxford_flowers", "stanford_cars",
    "oxford_pets", "food101", "sun397", "ucf101", "caltech101", "imagenet",
]


def job_done(output_dir: str, phase: str = "test") -> bool:
    """Whether a job's output directory (relative to the repository root,
    where the jobs run) holds a finished log.  A reused directory keeps
    its first log.txt and each later run writes log.txt-<timestamp> (the
    logger's rule), so a retry that succeeded after a crash is found in a
    later file: every log counts.  A train job is done at its end marker
    only (the per-epoch evaluation prints "=> result" long before the
    last checkpoint); a test job at either."""
    logs = sorted(glob.glob(os.path.join(REPO, output_dir, "log.txt*")))
    for log in logs:
        with open(log) as f:
            tail = f.read()
        if "Finish training" in tail or (phase != "train" and "=> result" in tail):
            return True
    return False


def make_base2new_jobs(args):
    jobs = []
    for dataset, seed, shot in itertools.product(args.datasets, args.seeds, args.shots):
        common = dict(dataset=dataset, seed=seed, shot=shot)
        config = ["--seed", str(seed), "--trainer", args.trainer,
                  "--dataset-config-file", f"configs/datasets/{dataset}.yaml",
                  "--config-file", f"configs/trainers/{args.trainer}/{args.cfg}.yaml"]
        train_dir = (f"output/{args.trainer.lower()}/base2new/train_base/{dataset}/"
                     f"shots_{shot}/{args.trainer}/{args.cfg}/seed{seed}")
        jobs.append({**common, "phase": "train", "output_dir": train_dir, "argv": [
            *config, "--output-dir", train_dir,
            "DATASET.NUM_SHOTS", str(shot), "DATASET.SUBSAMPLE_CLASSES", "base"]})
        for sub in ("base", "new"):
            test_dir = (f"output/{args.trainer.lower()}/base2new/test_{sub}/{dataset}/"
                        f"shots_{shot}/{args.trainer}/{args.cfg}/seed{seed}")
            jobs.append({**common, "phase": f"test_{sub}", "output_dir": test_dir,
                         "train_dir": train_dir, "argv": [
                             *config, "--output-dir", test_dir, "--model-dir", train_dir,
                             "--load-epoch", str(args.load_epoch), "--eval-only",
                             "DATASET.NUM_SHOTS", str(shot), "DATASET.SUBSAMPLE_CLASSES", sub]})
    return jobs


def shard_jobs(jobs, shard: str):
    """The jobs of the i-th of M shards (``shard`` "i/M") of the sorted
    (dataset, seed, shot) keys; all jobs for an empty ``shard``."""
    if not shard:
        return jobs
    i, m = (int(x) for x in shard.split("/"))
    keys = sorted({(j["dataset"], j["seed"], j["shot"]) for j in jobs})
    mine = {k for n, k in enumerate(keys) if n % m == i}
    return [j for j in jobs if (j["dataset"], j["seed"], j["shot"]) in mine]


def job_argv(job, root: str = ""):
    """The command of a job: the port's CLI, with ``--root`` before the
    KEY VALUE overrides (the CLI's opts take the rest of the line)."""
    argv = [sys.executable, "-m", "rpo_tpu_torch.cli"]
    if root:
        argv += ["--root", root]
    return argv + job["argv"]


def run_job(job, args) -> bool:
    if job_done(job["output_dir"], job["phase"]):
        print(f"[skip] {job['output_dir']} (already complete)")
        return True
    argv = job_argv(job, args.root)
    for attempt in range(args.retries + 1):
        t0 = time.time()
        proc = subprocess.run(argv, cwd=REPO)
        ok = proc.returncode == 0 and job_done(job["output_dir"], job["phase"])
        status = "ok" if ok else f"FAILED rc={proc.returncode}"
        print(f"[{status}] {job['output_dir']} ({time.time() - t0:.0f}s, attempt {attempt + 1})")
        if ok:
            return True
    return False


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("protocol", choices=["base2new"])
    parser.add_argument("--trainer", default="RPO")
    parser.add_argument("--cfg", default="main_K24")
    parser.add_argument("--datasets", nargs="+", default=B2N_DATASETS)
    parser.add_argument("--seeds", nargs="+", type=int, default=[1, 2, 3])
    parser.add_argument("--shots", nargs="+", type=int, default=[16])
    parser.add_argument("--load-epoch", type=int, default=15)
    parser.add_argument("--root", default=os.environ.get("DATA", ""))
    parser.add_argument("--workers", type=int, default=1,
                        help="concurrent jobs on this host (one a card)")
    parser.add_argument("--retries", type=int, default=1)
    parser.add_argument("--shard", default="",
                        help="i/M: run only the i-th of M shards of the (dataset, seed, shot) "
                             "matrix")
    args = parser.parse_args(argv)

    jobs = shard_jobs(make_base2new_jobs(args), args.shard)
    # train jobs first: the test jobs load their checkpoints
    train_jobs = [j for j in jobs if j["phase"] == "train"]
    test_jobs = [j for j in jobs if j["phase"] != "train"]
    print(f"{len(train_jobs)} train + {len(test_jobs)} test jobs")

    failures, blocked = [], []
    for phase_idx, batch in enumerate((train_jobs, test_jobs)):
        if phase_idx == 1:
            # a test job whose train run never finished would fail (no
            # checkpoint) or evaluate a stale checkpoint a previous sweep
            # left in the same train_dir: it is reported blocked instead.
            # A finished test job stays runnable (run_job skips it).
            ready = []
            for j in batch:
                if job_done(j["output_dir"], j["phase"]) or job_done(j["train_dir"], "train"):
                    ready.append(j)
                else:
                    print(f"[blocked] {j['output_dir']} (train incomplete: {j['train_dir']})")
                    blocked.append(j["output_dir"])
            batch = ready
        with ThreadPoolExecutor(max_workers=args.workers) as pool:
            for job, ok in zip(batch, pool.map(lambda j: run_job(j, args), batch)):
                if not ok:
                    failures.append(job["output_dir"])
    n_bad = len(failures) + len(blocked)
    print(f"sweep complete: {len(jobs) - n_bad}/{len(jobs)} ok")
    if blocked:
        print("blocked test jobs (train incomplete):")
        for b in blocked:
            print(" ", b)
    if failures:
        print("failed jobs:")
        for f in failures:
            print(" ", f)
    return 1 if failures or blocked else 0


if __name__ == "__main__":
    sys.exit(main())
