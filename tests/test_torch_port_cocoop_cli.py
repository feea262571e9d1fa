"""The port's CLI against the JAX package's for CoCoOp training, at the
protocol config's batch (the monolithic step) and at batch 16 (exact
gradient accumulation over chunks of 8).

As tests/test_torch_port_baselines_cli.py: both ``cli.main`` in process
on the CPU, the synthetic dataset's 5 base classes at 4 shots (batch 4:
5 steps an epoch; batch 16: one), TINY at 32 x 32, two epochs of
configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml in float32, seed 1;
the JAX run's seed-1 TINY backbone through the weight bridge and the same
context and meta-net from MODEL.INIT_WEIGHTS.

Tolerances (tests/test_torch_port_engine_run.py's float32 ones): every
step loss within 1e-5; each saved tensor's movement and each momentum
tensor of the last checkpoint within 1e-5 + 1e-4 x its largest entry;
equal ``* accuracy:`` lines.  Then each package's eval-only run of the
other's checkpoint prints the other's accuracy.
"""
import os
import pickle

import jax
import numpy as np
import pytest

from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu.models.clip import ARCHS, init_clip
from rpo_tpu_torch import cli as tcli
from rpo_tpu_torch.methods.base_trainer import CLIPMethodTrainer as PortTrainer
from rpo_tpu_torch.models.clip import params_from_numpy
from tests.test_torch_port_engine_run import accuracy, jax_cli, run  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 2
D = 64  # TINY's embed_dim and text width; the meta-net's hidden width is D // 16


def cli_args(out, init, batch, extra=()):
    return ["--seed", "1", "--trainer", "CoCoOp",
            "--dataset-config-file", os.path.join(REPO, "configs/datasets/synthetic.yaml"),
            "--config-file",
            os.path.join(REPO, "configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml"),
            "--output-dir", out, *extra,
            "DATASET.NUM_SHOTS", "4", "DATASET.SUBSAMPLE_CLASSES", "base",
            "OPTIM.MAX_EPOCH", str(EPOCHS), "MODEL.BACKBONE.NAME", "TINY",
            "INPUT.SIZE", "(32, 32)", "DATALOADER.TRAIN_X.BATCH_SIZE", str(batch),
            "DATALOADER.TEST.BATCH_SIZE", "16", "TRAINER.COCOOP.PREC", "fp32",
            "MODEL.INIT_WEIGHTS", init, "TRAIN.PREWARM_COMPILE", "False",
            "DATALOADER.NUM_WORKERS", "2"]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    else:
        yield path, np.asarray(tree)


def _close_as_gradient(got, want, what):
    got = dict(_leaves(got))
    for path, w in _leaves(want):
        g = got.pop(path)
        big, err = np.abs(w).max(), np.abs(g - w).max()
        assert big > 0 and err <= 1e-5 + 1e-4 * big, f"{what} {path}: max err {err} at max {big}"
    assert not got, f"{what}: extra tensors {sorted(got)}"


@pytest.fixture(scope="module")
def t_clip():
    return params_from_numpy(jax.tree_util.tree_map(
        np.asarray, init_clip(jax.random.PRNGKey(1), ARCHS["TINY"])), "cpu")


@pytest.fixture(scope="module", params=[4, 16], ids=["batch 4, monolithic",
                                                     "batch 16, accumulated"])
def runs(request, tmp_path_factory, jax_cli, t_clip):
    batch = request.param
    tmp = tmp_path_factory.mktemp(f"cocoop_cli_{batch}")
    rng = np.random.RandomState(0)
    init = {"ctx": (rng.randn(4, D) * 0.02).astype(np.float32), "meta_net": {
        "w1": (rng.randn(D, D // 16) * D ** -0.5).astype(np.float32),
        "b1": (rng.randn(D // 16) * 0.1).astype(np.float32),
        "w2": (rng.randn(D // 16, D) * (D // 16) ** -0.5).astype(np.float32),
        "b2": (rng.randn(D) * 0.1).astype(np.float32)}}
    init_path = str(tmp / "init.pkl")
    with open(init_path, "wb") as f:
        pickle.dump({"state_dict": init, "epoch": 0}, f)
    mp = pytest.MonkeyPatch()
    try:
        jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
        j_losses, j_log = run(jax_cli, JaxTrainer, cli_args(jax_out, init_path, batch), mp)
        mp.setenv("RPO_TPU_FORCE_CPU", "1")
        p_losses, p_log = run(tcli, PortTrainer, cli_args(port_out, init_path, batch), mp,
                              clip_params=t_clip)
    finally:
        mp.undo()
    return dict(batch=batch, init=init, init_path=init_path, jax_out=jax_out, port_out=port_out,
                j_losses=j_losses, p_losses=p_losses, j_log=j_log, p_log=p_log)


def _ckpt(out):
    with open(os.path.join(out, "prompt_learner", f"model.pth.tar-{EPOCHS}"), "rb") as f:
        return pickle.load(f)


def test_step_losses_equal_jax(runs):
    assert len(runs["p_losses"]) == len(runs["j_losses"]) == EPOCHS * (20 // runs["batch"])
    np.testing.assert_allclose(runs["p_losses"], runs["j_losses"], rtol=0, atol=1e-5)
    for log in (runs["p_log"], runs["j_log"]):
        assert "Finish training" in log and " acc " in log


def test_saved_tree_and_momentum_equal_jax(runs):
    j, p = _ckpt(runs["jax_out"]), _ckpt(runs["port_out"])
    assert p["epoch"] == j["epoch"] == EPOCHS
    moved = jax.tree_util.tree_map(lambda a, b: a - b, p["state_dict"], runs["init"])
    want = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, j["state_dict"], runs["init"])
    _close_as_gradient(moved, want, "movement")
    _close_as_gradient(p["optimizer"], jax.tree_util.tree_map(np.asarray, j["optimizer"]),
                       "momentum")


def test_accuracy_equals_jax(runs):
    assert accuracy(runs["p_log"]) == accuracy(runs["j_log"]) and len(accuracy(runs["p_log"])) == 1


def test_checkpoints_load_across_packages(runs, jax_cli, t_clip, tmp_path, monkeypatch):
    """Eval-only runs of the other package's checkpoint (the nested
    meta-net tree) print that package's accuracy."""
    extra = ["--eval-only", "--load-epoch", str(EPOCHS), "--model-dir"]
    _, log = run(jax_cli, JaxTrainer, cli_args(str(tmp_path / "jax_eval"), runs["init_path"],
                                               runs["batch"], extra + [runs["port_out"]]),
                 monkeypatch)
    assert accuracy(log) == accuracy(runs["p_log"])
    monkeypatch.setenv("RPO_TPU_FORCE_CPU", "1")
    _, log = run(tcli, PortTrainer, cli_args(str(tmp_path / "port_eval"), runs["init_path"],
                                             runs["batch"], extra + [runs["jax_out"]]),
                 monkeypatch, clip_params=t_clip)
    assert "Loading weights to prompt_learner" in log
    assert accuracy(log) == accuracy(runs["j_log"])
