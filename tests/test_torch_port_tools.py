"""The port's tools against the JAX package's, on the CPU.

``rpo_tpu_torch/tools/``: ``export_torch_ckpt`` (the same torch payload
as ``tools/export_torch_ckpt.py``, read back by both packages' loaders),
``profile_step`` (its four phases at TINY, as ``tests/test_tools_smoke.py``
runs the JAX tool's, and a ranking under ``RPO_TPU_FORCE_CPU=1``),
``sweep`` (the job matrix, ``job_done`` and the shards of
``scripts/sweep.py``, the jobs on the port's CLI), ``bench_device_preprocess``
(one JSON line at a small size) and ``validate_real_weights`` (exit 2 and
its diagnosis without weights, as ``scripts/validate_real_weights.py``).
"""
import argparse
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from rpo_tpu_torch.tools import bench_device_preprocess, export_torch_ckpt, profile_step
from rpo_tpu_torch.tools import sweep, validate_real_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _states():
    rng = np.random.RandomState(0)
    f32 = np.float32
    return {
        "rpo": {"text_prompt": rng.randn(4, 16).astype(f32),
                "img_prompt": rng.randn(4, 24).astype(f32)},
        "coop": {"ctx": rng.randn(4, 16).astype(f32)},
        "cocoop": {"ctx": rng.randn(4, 16).astype(f32), "meta_net": {
            "w1": rng.randn(8, 2).astype(f32), "b1": rng.randn(2).astype(f32),
            "w2": rng.randn(2, 16).astype(f32), "b2": rng.randn(16).astype(f32)}},
        "lp": {"w": rng.randn(6, 5).astype(f32), "b": rng.randn(5).astype(f32)},
    }


@pytest.mark.parametrize("method", ["rpo", "coop", "cocoop", "lp"])
def test_export_equals_the_jax_tools_and_reads_back(tmp_path, method):
    from rpo_tpu.engine.trainer import _load_checkpoint_file as jax_load
    from tools.export_torch_ckpt import export as jax_export

    from rpo_tpu_torch.engine.trainer import _load_checkpoint_file as port_load

    src = tmp_path / "model.pth.tar-15"
    with open(src, "wb") as f:  # the payload both packages write
        pickle.dump({"state_dict": _states()[method], "epoch": 15, "optimizer": None,
                     "val_result": 80.0}, f)
    ours, theirs = str(tmp_path / "port.torch"), str(tmp_path / "jax.torch")
    assert export_torch_ckpt.export(str(src), ours) == jax_export(str(src), theirs) == method
    got = torch.load(ours, map_location="cpu", weights_only=False)
    want = torch.load(theirs, map_location="cpu", weights_only=False)
    assert set(got) == set(want) == {"state_dict", "epoch", "val_result"}
    assert (got["epoch"], got["val_result"]) == (want["epoch"], want["val_result"]) == (15, 80.0)
    assert set(got["state_dict"]) == set(want["state_dict"])
    for key, t in got["state_dict"].items():
        assert torch.equal(t, want["state_dict"][key]), key
    for load in (port_load, jax_load):
        back = load(ours)
        assert back["epoch"] == 15
        for key, t in got["state_dict"].items():
            np.testing.assert_array_equal(back["state_dict"][key], t.numpy())


def test_export_cli_names_its_output(tmp_path, capsys):
    src = tmp_path / "model.pth.tar-2"
    with open(src, "wb") as f:
        pickle.dump({"state_dict": _states()["coop"], "epoch": 2}, f)
    assert export_torch_ckpt.main([str(src)]) == 0
    assert os.path.exists(str(src) + ".torch")
    assert "(coop)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="cannot infer method"):
        export_torch_ckpt.detect_method({"weights": 1})


def _profile_args(phase: str, batch: int) -> argparse.Namespace:
    return argparse.Namespace(phase=phase, steps=2, batch=batch, n_cls=5, k=4, backbone="TINY",
                              top=5)


@pytest.mark.parametrize("phase,batch",
                         [("train", 2), ("eval", 4), ("cocoop-train", 2), ("cocoop-eval", 4)])
def test_profile_step_build_phases(phase, batch):
    run_one = profile_step.build(_profile_args(phase, batch), device="cpu")
    for _ in range(2):
        out = run_one()
        assert bool(torch.isfinite(out.float()).all())
    if phase.endswith("eval"):
        assert tuple(out.shape) == (batch, 5)


def test_profile_step_prints_a_ranking_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("RPO_TPU_FORCE_CPU", "1")
    assert profile_step.main(["--phase", "eval", "--steps", "2", "--batch", "2", "--n-cls", "5",
                              "--k", "4", "--backbone", "TINY", "--top", "5",
                              "--trace-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    head, _, groups = out.partition("by group:")
    assert "CPU ops by total time (eval, 2 steps, batch 2, TINY, on cpu):" in head
    assert len([ln for ln in head.splitlines() if "us/step" in ln]) == 5
    assert "%" in groups and "device busy and idle share not measured" in groups
    assert os.path.exists(tmp_path / "eval.json")


def _sweep_args(**kw):
    args = dict(trainer="RPO", cfg="main_K24", datasets=["caltech101", "dtd", "eurosat"],
                seeds=[1, 2], shots=[16, 4], load_epoch=15, root="/data", workers=1,
                retries=1, shard="")
    args.update(kw)
    return argparse.Namespace(**args)


def test_sweep_job_matrix_equals_the_jax_scripts():
    import scripts.sweep as jsweep

    args = _sweep_args()
    assert sweep.make_base2new_jobs(args) == jsweep.make_base2new_jobs(args)
    assert sweep.B2N_DATASETS == jsweep.B2N_DATASETS


@pytest.mark.parametrize("shard", ["", "0/1", "1/3", "2/4"])
def test_sweep_runs_the_jax_scripts_jobs(monkeypatch, shard):
    """Both mains, every job done and run_job recording: the same jobs in
    the same order, shard by shard."""
    import scripts.sweep as jsweep

    argv = ["base2new", "--datasets", "caltech101", "dtd", "eurosat", "--seeds", "1", "2",
            "--shots", "16", "4"] + (["--shard", shard] if shard else [])
    ran = {}
    for name, module in (("jax", jsweep), ("port", sweep)):
        seen = ran[name] = []
        monkeypatch.setattr(module, "job_done", lambda *a, **k: True)
        monkeypatch.setattr(module, "run_job", lambda job, args, seen=seen: seen.append(job)
                            or True)
    monkeypatch.setattr(sys, "argv", ["sweep.py"] + argv)
    jsweep.main()
    assert sweep.main(argv) == 0
    assert ran["port"] == ran["jax"] and ran["port"]


def test_sweep_job_done_equals_the_jax_scripts(tmp_path):
    import scripts.sweep as jsweep

    logs = {"empty": None, "result": "=> result\n* accuracy: 50.0%",
            "finished": "Finish training\n", "retry": None, "partial": "epoch [1/15]"}
    for name, text in logs.items():
        d = tmp_path / name
        d.mkdir()
        if text is not None:
            (d / "log.txt").write_text(text)
    (tmp_path / "retry" / "log.txt").write_text("Traceback")
    (tmp_path / "retry" / "log.txt-2026-01-01-00-00-00").write_text("Finish training")
    for name in logs:
        for phase in ("train", "test", "test_base"):
            path = str(tmp_path / name)
            assert sweep.job_done(path, phase) == jsweep.job_done(path, phase), (name, phase)
    assert sweep.job_done(str(tmp_path / "retry"), "train")
    assert not sweep.job_done(str(tmp_path / "result"), "train")


def test_sweep_jobs_run_the_ports_cli(monkeypatch):
    import scripts.sweep as jsweep

    job = sweep.make_base2new_jobs(_sweep_args(datasets=["dtd"], seeds=[1], shots=[16]))[1]
    argv = sweep.job_argv(job, "/data")
    assert argv[:5] == [sys.executable, "-m", "rpo_tpu_torch.cli", "--root", "/data"]
    # the JAX script's command after its train.py: the same arguments
    jax_argv = [sys.executable, "train.py"] + job["argv"]
    jax_argv[2:2] = ["--root", "/data"]
    assert argv[3:] == jax_argv[2:]
    calls = []
    monkeypatch.setattr(sweep, "job_done", lambda d, p="test": bool(calls))
    monkeypatch.setattr(sweep.subprocess, "run", lambda a, cwd: calls.append((a, cwd)) or
                        subprocess.CompletedProcess(a, 0))
    assert sweep.run_job(job, _sweep_args(root="/data"))
    assert calls == [(argv, sweep.REPO)]
    assert jsweep.REPO == sweep.REPO == ROOT


@pytest.mark.parametrize("phase", ["eval", "train"])
def test_bench_device_preprocess_prints_one_json_line(monkeypatch, capsys, phase):
    monkeypatch.setenv("RPO_TPU_FORCE_CPU", "1")
    assert bench_device_preprocess.main(["--phase", phase, "--backbone", "TINY", "--src", "16",
                                         "--batch", "4", "--iters", "1", "--n-cls", "5",
                                         "--k", "4"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == ("device_resize_eval_images_per_sec" if phase == "eval"
                             else "device_augment_train_images_per_sec")
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["device"] == "cpu" and "not a device measurement" in rec["unit"]
    if phase == "eval":
        # the host's Pillow-exact resample and the device resize agree
        assert rec["extras"]["top1_agreement_host_vs_device_resize"] == 1.0
        assert rec["extras"]["h2d_bytes_per_batch_device_path"] == 4 * 16 * 16 * 3


def test_validate_real_weights_diagnoses_missing_weights(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CLIP_CHECKPOINT", "RPO_TPU_ALLOW_DOWNLOAD")}
    env.update(CLIP_CACHE_DIR=str(tmp_path / "empty_cache"), PYTHONPATH=ROOT,
               RPO_TPU_FORCE_CPU="1")
    proc = subprocess.run([sys.executable, "-m", "rpo_tpu_torch.tools.validate_real_weights"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "No real weights" in proc.stdout
    assert "$CLIP_CHECKPOINT" in proc.stdout
    env["CLIP_CHECKPOINT"] = str(tmp_path / "missing.pt")
    proc = subprocess.run([sys.executable, "-m", "rpo_tpu_torch.tools.validate_real_weights"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and "(file missing)" in proc.stdout


def test_validate_real_weights_fails_random_weights_as_jax_does(tmp_path, monkeypatch, capsys):
    """A checkpoint of random weights: both tools load it and fail the
    semantic smoke (exit 1); the port skips the tower parity without
    ``--reference``."""
    from rpo_tpu_torch.models.clip import ARCHS
    from rpo_tpu_torch.models.clip.convert import state_dict_shapes

    rng = np.random.RandomState(0)
    sd = {}
    for key, shape in state_dict_shapes(ARCHS["TINY"]).items():
        std = 1.0 if key == "logit_scale" else 0.02
        sd[key] = torch.from_numpy(np.asarray(rng.randn(*shape) * std, np.float32))
    path = str(tmp_path / "tiny.pt")
    torch.save(sd, path)
    monkeypatch.delenv("RPO_TPU_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.setenv("CLIP_CHECKPOINT", path)
    monkeypatch.setenv("RPO_TPU_FORCE_CPU", "1")
    assert validate_real_weights.main(["--backbone", "TINY"]) == 1
    out = capsys.readouterr().out
    assert f"weights: {path}" in out and "tower parity: SKIPPED" in out
    assert "SEMANTIC SMOKE FAILED" in out
    env = {**os.environ, "PYTHONPATH": ROOT}
    script = os.path.join(ROOT, "scripts", "validate_real_weights.py")
    proc = subprocess.run([sys.executable, script, "--backbone", "TINY", "--skip-torch"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and "SEMANTIC SMOKE FAILED" in proc.stdout + proc.stderr
