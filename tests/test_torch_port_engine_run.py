"""The port's CLI run against the JAX package's, in process.

Both ``rpo_tpu.cli.main`` and ``rpo_tpu_torch.cli.main`` run the JAX
engine tests' synthetic fixture (tests/test_engine_e2e.py: 4 shots, base
classes, TINY at 32 x 32, train batch 8, test batch 16, two epochs of
configs/trainers/RPO/main.yaml, seed 1) on the CPU.  The port gets the
JAX run's random TINY backbone through the weight bridge, and both start
from the same prompts, a pickled payload of ``rpo_tpu.methods.rpo.
init_prompts`` named by MODEL.INIT_WEIGHTS.  The data needs no bridge:
both draw the same batches from the seeded global ``random``
(tests/test_torch_port_data.py).

Tolerances are tests/test_torch_port_rpo_train.py's: every step loss
within its loss tolerance (float32 1e-5, bfloat16 0.02), the prompts'
movement and the momentum of ``model.pth.tar-2`` as a gradient there
(float32 1e-5 + 1e-4 x the largest entry; bfloat16 largest error <= 0.1
of the largest entry and cosine >= 0.99), and equal ``* accuracy:``
lines.  Then a checkpoint of either package loads in the other and gives
the same accuracy.
"""
import os
import pickle
import re
import sys

import jax
import numpy as np
import pytest

from rpo_tpu.methods import rpo as jcore
from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu.models.clip import ARCHS, init_clip
from rpo_tpu_torch import cli as tcli
from rpo_tpu_torch.methods.base_trainer import CLIPMethodTrainer as PortTrainer
from rpo_tpu_torch.models.clip import params_from_numpy
from tests.test_torch_port_rpo_train import BF16_GRAD_COS, BF16_GRAD_REL, TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4  # configs/trainers/RPO/main.yaml
PREC_DTYPE = {"fp32": "float32", "fp16": "bfloat16"}


def fixture_args(out, prec, init, extra=()):
    return [
        "--seed", "1", "--trainer", "RPO",
        "--dataset-config-file", os.path.join(REPO, "configs/datasets/synthetic.yaml"),
        "--config-file", os.path.join(REPO, "configs/trainers/RPO/main.yaml"),
        "--output-dir", out, *extra,
        "DATASET.NUM_SHOTS", "4", "DATASET.SUBSAMPLE_CLASSES", "base",
        "OPTIM.MAX_EPOCH", "2", "MODEL.BACKBONE.NAME", "TINY", "INPUT.SIZE", "(32, 32)",
        "DATALOADER.TRAIN_X.BATCH_SIZE", "8", "DATALOADER.TEST.BATCH_SIZE", "16",
        "TRAINER.RPO.PREC", prec, "MODEL.INIT_WEIGHTS", init,
        "TRAIN.PREWARM_COMPILE", "False", "DATALOADER.NUM_WORKERS", "2",
    ]


def run(main_mod, trainer_cls, argv, monkeypatch, **build_kwargs):
    """One in-process CLI run: (every step's loss, the log text).  The
    logger's tee of stdout is undone afterwards."""
    losses = []
    step = trainer_cls.forward_backward

    def recording(self, batch):
        summary = step(self, batch)
        losses.append(float(summary["loss"]))
        return summary

    monkeypatch.setattr(trainer_cls, "forward_backward", recording)
    stdout = sys.stdout
    try:
        main_mod.main(main_mod.build_parser().parse_args(argv), **build_kwargs)
    finally:
        sys.stdout = stdout
    monkeypatch.setattr(trainer_cls, "forward_backward", step)
    out = argv[argv.index("--output-dir") + 1]
    with open(os.path.join(out, "log.txt")) as f:
        return losses, f.read()


def accuracy(log):
    return re.findall(r"\* accuracy: ([\d.]+)%", log)


def load_ckpt(out, epoch=2):
    with open(os.path.join(out, "prompt_learner", f"model.pth.tar-{epoch}"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_cli():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RPO_TPU_XLA_CACHE", "0")  # read at import: no cache outside the run
        from rpo_tpu import cli
    return cli


@pytest.fixture(scope="module", params=["fp32", "fp16"])
def runs(request, tmp_path_factory, jax_cli):
    prec = request.param
    tmp = tmp_path_factory.mktemp(f"engine_run_{prec}")
    jclip = init_clip(jax.random.PRNGKey(1), ARCHS["TINY"])  # JAX's seed-1 backbone
    prompts = jax.tree_util.tree_map(
        np.asarray, jcore.init_prompts(jax.random.PRNGKey(0), jclip, ARCHS["TINY"], K))
    init = str(tmp / "init_prompts.pkl")
    with open(init, "wb") as f:
        pickle.dump({"state_dict": prompts, "epoch": 0}, f)
    mp = pytest.MonkeyPatch()
    try:
        jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
        j_losses, j_log = run(jax_cli, JaxTrainer, fixture_args(jax_out, prec, init), mp)
        mp.setenv("RPO_TPU_FORCE_CPU", "1")
        t_clip = params_from_numpy(jax.tree_util.tree_map(np.asarray, jclip), "cpu")
        p_losses, p_log = run(tcli, PortTrainer, fixture_args(port_out, prec, init), mp,
                              clip_params=t_clip)
    finally:
        mp.undo()
    return dict(prec=prec, dtype=PREC_DTYPE[prec], prompts=prompts, init=init, tmp=tmp,
                jax_out=jax_out, port_out=port_out, j_losses=j_losses, p_losses=p_losses,
                j_log=j_log, p_log=p_log, t_clip=t_clip)


def _close_as_gradient(got, want, dtype, what):
    for key in want:
        g, w = np.ravel(got[key]), np.ravel(want[key])
        big, err = np.abs(w).max(), np.abs(g - w).max()
        assert big > 0, what
        if dtype == "float32":
            assert err <= 1e-5 + 1e-4 * big, f"{what} {key}: max err {err} at max {big}"
        else:
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
            assert err / big <= BF16_GRAD_REL and cos >= BF16_GRAD_COS, (
                f"{what} {key}: max err / max {err / big}, cosine {cos}")


def test_step_losses_equal_jax(runs):
    """Two epochs of 2 steps (20 base images, batch 8, drop_last): each
    step's loss, and the log's loss lines, one per epoch."""
    assert len(runs["p_losses"]) == len(runs["j_losses"]) == 4
    np.testing.assert_allclose(runs["p_losses"], runs["j_losses"], rtol=0,
                               atol=TOL[runs["dtype"]]["loss"])
    line = re.compile(r"epoch \[\d/2\] batch \[2/2\] .* loss [\d.]+ \([\d.]+\) lr ")
    assert len(line.findall(runs["p_log"])) == len(line.findall(runs["j_log"])) == 2


def test_saved_prompts_and_momentum_equal_jax(runs):
    j, p = load_ckpt(runs["jax_out"]), load_ckpt(runs["port_out"])
    assert p["epoch"] == j["epoch"] == 2
    assert set(p["state_dict"]) == set(j["state_dict"]) == {"text_prompt", "img_prompt"}
    moved = {k: p["state_dict"][k] - runs["prompts"][k] for k in runs["prompts"]}
    want = {k: j["state_dict"][k] - runs["prompts"][k] for k in runs["prompts"]}
    _close_as_gradient(moved, want, runs["dtype"], "prompt movement")
    _close_as_gradient(p["optimizer"], j["optimizer"], runs["dtype"], "momentum")
    for a in list(p["state_dict"].values()) + list(p["optimizer"].values()):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32


def test_accuracy_equals_jax(runs):
    assert accuracy(runs["p_log"]) == accuracy(runs["j_log"])
    assert len(accuracy(runs["p_log"])) == 1


def test_checkpoints_load_across_packages(runs, jax_cli, tmp_path, monkeypatch):
    """Eval-only from the other package's output directory gives the
    accuracy that package's own final test printed (fp32 and bf16)."""
    prec, init = runs["prec"], runs["init"]
    _, log = run(jax_cli, JaxTrainer, fixture_args(
        str(tmp_path / "jax_eval"), prec, init,
        ["--eval-only", "--model-dir", runs["port_out"], "--load-epoch", "2"]), monkeypatch)
    assert "Loading weights to prompt_learner" in log
    assert accuracy(log) == accuracy(runs["p_log"])
    monkeypatch.setenv("RPO_TPU_FORCE_CPU", "1")
    _, log = run(tcli, PortTrainer, fixture_args(
        str(tmp_path / "port_eval"), prec, init,
        ["--eval-only", "--model-dir", runs["jax_out"], "--load-epoch", "2"]), monkeypatch,
        clip_params=runs["t_clip"])
    assert "Loading weights to prompt_learner" in log
    assert accuracy(log) == accuracy(runs["j_log"])
