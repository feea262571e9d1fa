"""The port's CLI and engine on the CPU: the log contract, checkpoints,
eval-only under another class set, resume, and the CLI as a program.

The runs use the JAX engine tests' synthetic fixture
(tests/test_engine_e2e.py) through ``rpo_tpu_torch.cli.main`` with
``RPO_TPU_FORCE_CPU=1`` on the port's own random TINY backbone; the
checks are the ones tests/test_engine_e2e.py makes of the JAX CLI.
"""
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rpo_tpu_torch import cli
from rpo_tpu_torch.engine import trainer as engine_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fixture_args(out, *extra, opts=()):
    return [
        "--seed", "1", "--trainer", "RPO",
        "--dataset-config-file", os.path.join(REPO, "configs/datasets/synthetic.yaml"),
        "--config-file", os.path.join(REPO, "configs/trainers/RPO/main.yaml"),
        "--output-dir", out, *extra,
        "DATASET.NUM_SHOTS", "4", "OPTIM.MAX_EPOCH", "2", "MODEL.BACKBONE.NAME", "TINY",
        "INPUT.SIZE", "(32, 32)", "DATALOADER.TRAIN_X.BATCH_SIZE", "8",
        "DATALOADER.TEST.BATCH_SIZE", "16", "TRAINER.RPO.PREC", "fp32",
        "DATALOADER.NUM_WORKERS", "2", *opts,
    ]


def run_main(argv):
    """``cli.main`` in process on the CPU; returns (trainer, the output
    directory's newest log text).  The logger's tee of stdout is undone."""
    stdout = sys.stdout
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RPO_TPU_FORCE_CPU", "1")
            trainer = cli.main(cli.build_parser().parse_args(argv))
    finally:
        sys.stdout = stdout
    out = argv[argv.index("--output-dir") + 1]
    logs = sorted((p for p in os.listdir(out) if p.startswith("log.txt")),
                  key=lambda p: os.path.getmtime(os.path.join(out, p)))
    with open(os.path.join(out, logs[-1])) as f:
        return trainer, f.read()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_rpo_synth"))
    trainer, log = run_main(fixture_args(out, opts=["DATASET.SUBSAMPLE_CLASSES", "base"]))
    return out, trainer, log


def test_train_produces_log_contract(trained):
    _, trainer, log = trained
    assert "Finish training" in log
    assert re.search(r"\* accuracy: ([\.\deE+-]+)%", log), log
    for line in ("=> result", "* total:", "* correct:", "* macro_f1:"):
        assert line in log
    assert "Device: cpu" in log and "PyTorch:" in log
    assert trainer.device == torch.device("cpu")
    assert trainer.dm.classnames == ["crimson finch", "glass teapot", "paper lantern",
                                     "granite cliff", "velvet chair"]


def test_checkpoint_files(trained):
    out, trainer, _ = trained
    assert sorted(os.listdir(os.path.join(out, "prompt_learner"))) == ["model.pth.tar-2"]
    with open(os.path.join(out, "prompt_learner", "model.pth.tar-2"), "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"state_dict", "epoch", "optimizer", "val_result"}
    assert payload["epoch"] == 2
    assert set(payload["state_dict"]) == {"text_prompt", "img_prompt"}
    assert payload["state_dict"]["text_prompt"].shape == (4, 64)  # TINY d_t, K 4
    assert set(payload["optimizer"]) == {"text_prompt", "img_prompt"}
    assert np.abs(payload["optimizer"]["img_prompt"]).max() > 0
    for key, t in trainer.params.items():
        np.testing.assert_array_equal(payload["state_dict"][key], t.numpy())


def test_eval_only_cross_class_set(trained, tmp_path):
    """A base-trained checkpoint evaluated on the new class half: the
    checkpoint holds no class-dependent tensor."""
    out, trainer, _ = trained
    evaluator, log = run_main(fixture_args(
        str(tmp_path / "eval_new"), "--eval-only", "--model-dir", out, "--load-epoch", "2",
        opts=["DATASET.SUBSAMPLE_CLASSES", "new"]))
    assert "Loading weights to prompt_learner" in log
    assert re.search(r"\* accuracy: ([\.\deE+-]+)%", log)
    assert "Finish training" not in log
    assert evaluator.dm.classnames == ["copper kettle", "neon sign", "willow tree",
                                       "marble statue", "cotton cloud"]
    for key, t in trainer.params.items():
        torch.testing.assert_close(evaluator.params[key], t, rtol=0, atol=0)


def test_resume_after_an_interrupted_run(tmp_path, monkeypatch):
    """A run stopped after epoch 1 (checkpoint every epoch) and relaunched
    with the same command resumes from model.pth.tar-1, says so, trains
    epoch 2 only and writes model.pth.tar-2."""
    out = str(tmp_path / "resume")
    argv = fixture_args(out, opts=["TRAIN.CHECKPOINT_FREQ", "1", "TEST.NO_TEST", "True"])
    run_epoch = engine_trainer.TrainerBase.run_epoch

    class Stopped(Exception):
        pass

    def stop_at_epoch_2(self):
        if self.epoch == 1:
            raise Stopped("stopped after epoch 1")
        run_epoch(self)

    monkeypatch.setattr(engine_trainer.TrainerBase, "run_epoch", stop_at_epoch_2)
    with pytest.raises(Stopped):
        run_main(argv)
    monkeypatch.setattr(engine_trainer.TrainerBase, "run_epoch", run_epoch)
    assert sorted(os.listdir(os.path.join(out, "prompt_learner"))) == ["model.pth.tar-1"]
    _, log = run_main(argv)
    assert f'Resumed prompt_learner from "{out}/prompt_learner/model.pth.tar-1" (epoch 1)' in log
    assert "epoch [1/2]" not in log and "epoch [2/2] done" in log
    assert sorted(os.listdir(os.path.join(out, "prompt_learner"))) == [
        "model.pth.tar-1", "model.pth.tar-2"]
    assert len([p for p in os.listdir(out) if p.startswith("log.txt")]) == 2  # old log kept


def test_cli_program_on_the_cpu_imports_no_pil_yaml_or_jax(tmp_path):
    """``python -m rpo_tpu_torch.cli`` with RPO_TPU_FORCE_CPU=1 exits 0
    and writes the contract lines; on the synthetic path neither Pillow
    nor PyYAML (nor JAX) is imported (``-X importtime`` lists every
    module the program imports)."""
    out = str(tmp_path / "program")
    env = {**os.environ, "RPO_TPU_FORCE_CPU": "1", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "rpo_tpu_torch.cli",
         *fixture_args(out, opts=["OPTIM.MAX_EPOCH", "1"])],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    log = open(os.path.join(out, "log.txt")).read()
    for line in ("Finish training", "=> result", "* accuracy:", "* total:", "* correct:",
                 "* macro_f1:"):
        assert line in log
    imported = {ln.rsplit("|", 1)[-1].strip().split(".")[0]
                for ln in proc.stderr.splitlines() if ln.startswith("import time:")}
    assert "rpo_tpu_torch" in imported and "torch" in imported
    assert not imported & {"PIL", "yaml", "jax", "rpo_tpu"}, imported & {"PIL", "yaml", "jax"}


def test_cli_program_without_a_card_fails_loudly(tmp_path):
    """Without RPO_TPU_FORCE_CPU and with no CUDA card the CLI exits
    non-zero with resolve_device's message, before any output file."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = {k: v for k, v in os.environ.items() if k != "RPO_TPU_FORCE_CPU"}
    env["PYTHONPATH"] = REPO
    out = str(tmp_path / "no_card")
    proc = subprocess.run([sys.executable, "-m", "rpo_tpu_torch.cli", *fixture_args(out)],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not os.path.exists(out)
