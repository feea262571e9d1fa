"""The port's CLI against the JAX package's for the baselines: CoOp and
LP training, ZeroshotCLIP and ZeroshotCLIP2 evaluation; the trainer
registry; ``parse_results`` on the logs both CLIs write.

Both ``rpo_tpu.cli.main`` and ``rpo_tpu_torch.cli.main`` run in process
on the CPU on the synthetic dataset (4 shots of the 5 base classes, TINY
at 32 x 32, test batch 16, seed 1; two epochs for the trainers that
train) with each method's protocol config in float32.  The port gets the
JAX run's random TINY backbone (JAX's seed-1 draw) through the weight
bridge, and both start from the same trainable tensors, a pickled
numpy payload named by MODEL.INIT_WEIGHTS.  Both draw the same batches
from the seeded global ``random`` (tests/test_torch_port_data.py).

Tolerances are tests/test_torch_port_engine_run.py's float32 ones: every
step loss within 1e-5, relative to the run's largest loss where that is
above 1 (LP's logits are products of unnormalised features, and its
losses reach ~40, which float32's summation order moves by ~1e-4), the
saved tensors' movement and the momentum of
the last checkpoint within 1e-5 + 1e-4 x their largest entry, and equal
``* accuracy:`` lines.  Zero-shot runs in bfloat16 whatever the config,
in both packages: the same accuracy lines.
"""
import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest

from rpo_tpu import parse_results as jparse
from rpo_tpu.engine.registry import TRAINER_REGISTRY as JAX_REGISTRY
from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu.models.clip import ARCHS, init_clip
from rpo_tpu_torch import cli as tcli
from rpo_tpu_torch import parse_results as tparse
from rpo_tpu_torch.engine import TRAINER_REGISTRY as PORT_REGISTRY
from rpo_tpu_torch.methods.base_trainer import CLIPMethodTrainer as PortTrainer
from rpo_tpu_torch.models.clip import params_from_numpy
from tests.test_torch_port_engine_run import (  # noqa: F401  (jax_cli is a fixture)
    _close_as_gradient, accuracy, jax_cli, run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 2
D = 64  # TINY's text width and embed_dim

# (trainer, config, batch size, saved model, initial trainable tensors)
TRAINED = {
    "CoOp": ("configs/trainers/CoOp/vit_b16_ep50_ctxv1.yaml", 8, "prompt_learner",
             lambda rng: {"ctx": rng.randn(4, D) * 0.02}),  # CTX_INIT "a photo of a": 4 words
    "LP": ("configs/trainers/LP/vit_b16_c4_ep10_batch1.yaml", 4, "lp_layer",
           lambda rng: {"w": np.eye(D) + rng.randn(D, D) * 0.05, "b": rng.randn(D) * 0.05}),
}


def common_args(out, trainer, extra=()):
    return ["--seed", "1", "--trainer", trainer,
            "--dataset-config-file", os.path.join(REPO, "configs/datasets/synthetic.yaml"),
            "--output-dir", out, *extra,
            "DATASET.NUM_SHOTS", "4", "DATASET.SUBSAMPLE_CLASSES", "base",
            "MODEL.BACKBONE.NAME", "TINY", "INPUT.SIZE", "(32, 32)",
            "DATALOADER.TEST.BATCH_SIZE", "16", "DATALOADER.NUM_WORKERS", "2"]


def trained_args(out, trainer, init, extra=()):
    config, batch, _, _ = TRAINED[trainer]
    return common_args(out, trainer, ["--config-file", os.path.join(REPO, config), *extra]) + [
        "OPTIM.MAX_EPOCH", str(EPOCHS), "DATALOADER.TRAIN_X.BATCH_SIZE", str(batch),
        f"TRAINER.{'COOP' if trainer == 'CoOp' else 'LP'}.PREC", "fp32",
        "MODEL.INIT_WEIGHTS", init, "TRAIN.PREWARM_COMPILE", "False"]


def write_init(path, tree):
    tree = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    with open(path, "wb") as f:
        pickle.dump({"state_dict": tree, "epoch": 0}, f)
    return tree


@pytest.fixture(scope="module")
def t_clip():
    """The port's copy of JAX's seed-1 TINY backbone (float32)."""
    return params_from_numpy(jax.tree_util.tree_map(
        np.asarray, init_clip(jax.random.PRNGKey(1), ARCHS["TINY"])), "cpu")


@pytest.fixture(scope="module", params=sorted(TRAINED))
def runs(request, tmp_path_factory, jax_cli, t_clip):
    trainer = request.param
    tmp = tmp_path_factory.mktemp(f"baseline_{trainer}")
    init_path = str(tmp / "init.pkl")
    init = write_init(init_path, TRAINED[trainer][3](np.random.RandomState(0)))
    mp = pytest.MonkeyPatch()
    try:
        jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
        j_losses, j_log = run(jax_cli, JaxTrainer, trained_args(jax_out, trainer, init_path), mp)
        mp.setenv("RPO_TPU_FORCE_CPU", "1")
        p_losses, p_log = run(tcli, PortTrainer, trained_args(port_out, trainer, init_path), mp,
                              clip_params=t_clip)
    finally:
        mp.undo()
    return dict(trainer=trainer, init=init, init_path=init_path, jax_out=jax_out,
                port_out=port_out, j_losses=j_losses, p_losses=p_losses, j_log=j_log,
                p_log=p_log)


def load_ckpt(out, name, epoch=EPOCHS):
    with open(os.path.join(out, name, f"model.pth.tar-{epoch}"), "rb") as f:
        return pickle.load(f)


def test_registry_names_equal_jax():
    assert PORT_REGISTRY.registered_names() == JAX_REGISTRY.registered_names() == [
        "CoCoOp", "CoOp", "LP", "RPO", "ZeroshotCLIP", "ZeroshotCLIP2"]


def test_step_losses_equal_jax(runs):
    """Every step's loss (20 base images a epoch, drop_last), and the log's
    loss and accuracy lines: the CoOp family logs both."""
    batch = TRAINED[runs["trainer"]][1]
    assert len(runs["p_losses"]) == len(runs["j_losses"]) == EPOCHS * (20 // batch)
    np.testing.assert_allclose(runs["p_losses"], runs["j_losses"], rtol=0,
                               atol=1e-5 * max(1.0, max(map(abs, runs["j_losses"]))))
    for log in (runs["p_log"], runs["j_log"]):
        assert "Finish training" in log and " acc " in log
        assert f"Initializing {TRAINED[runs['trainer']][2]} from" in log


def test_saved_tensors_and_momentum_equal_jax(runs):
    name = TRAINED[runs["trainer"]][2]
    j, p = load_ckpt(runs["jax_out"], name), load_ckpt(runs["port_out"], name)
    assert p["epoch"] == j["epoch"] == EPOCHS
    assert set(p["state_dict"]) == set(j["state_dict"]) == set(runs["init"])
    moved = {k: p["state_dict"][k] - runs["init"][k] for k in runs["init"]}
    want = {k: j["state_dict"][k] - runs["init"][k] for k in runs["init"]}
    _close_as_gradient(moved, want, "float32", "movement")
    _close_as_gradient(p["optimizer"], j["optimizer"], "float32", "momentum")
    assert sorted(os.listdir(os.path.join(runs["port_out"], name))) == [
        f"model.pth.tar-{EPOCHS}"]


def test_accuracy_equals_jax(runs):
    assert accuracy(runs["p_log"]) == accuracy(runs["j_log"])
    assert len(accuracy(runs["p_log"])) == 1


def test_eval_only_reload_and_resume(runs, tmp_path, t_clip, monkeypatch):
    """Eval-only from the JAX run's directory prints the JAX run's
    accuracy; a rerun into the port's own directory resumes from its last
    checkpoint and trains no step."""
    monkeypatch.setenv("RPO_TPU_FORCE_CPU", "1")
    trainer, name = runs["trainer"], TRAINED[runs["trainer"]][2]
    _, log = run(tcli, PortTrainer, trained_args(
        str(tmp_path / "eval"), trainer, runs["init_path"],
        ["--eval-only", "--model-dir", runs["jax_out"], "--load-epoch", str(EPOCHS)]),
        monkeypatch, clip_params=t_clip)
    assert f"Loading weights to {name}" in log
    assert accuracy(log) == accuracy(runs["j_log"])
    resumed = str(tmp_path / "resume")
    shutil.copytree(os.path.join(runs["port_out"], name), os.path.join(resumed, name))
    losses, log = run(tcli, PortTrainer, trained_args(resumed, trainer, runs["init_path"]),
                      monkeypatch, clip_params=t_clip)
    assert losses == [] and f"Resumed {name}" in log


@pytest.fixture(scope="module")
def zero_shot(tmp_path_factory, jax_cli, t_clip):
    tmp = tmp_path_factory.mktemp("zero_shot")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for trainer in ("ZeroshotCLIP", "ZeroshotCLIP2"):
            mp.delenv("RPO_TPU_FORCE_CPU", raising=False)
            _, j_log = run(jax_cli, JaxTrainer, common_args(
                str(tmp / f"jax_{trainer}"), trainer, ["--eval-only"]), mp)
            mp.setenv("RPO_TPU_FORCE_CPU", "1")
            _, p_log = run(tcli, PortTrainer, common_args(
                str(tmp / f"port_{trainer}"), trainer, ["--eval-only"]), mp, clip_params=t_clip)
            out[trainer] = (j_log, p_log)
    finally:
        mp.undo()
    return tmp, out


def test_zero_shot_eval_only_equals_jax(zero_shot):
    """The dataset's template (Synthetic: 'a photo of a {}.') and the
    8-template ensemble: the same accuracy as JAX's; no training, no
    checkpoint."""
    tmp, out = zero_shot
    for trainer, (j_log, p_log) in out.items():
        assert accuracy(p_log) == accuracy(j_log) and len(accuracy(p_log)) == 1, trainer
        assert "Finish training" not in p_log
        assert "Note that load_model() is skipped" in p_log
        want = ("Prompt ensembling (n=8)" if trainer == "ZeroshotCLIP2"
                else "Prompts template: 'a photo of a {}.'")
        assert want in p_log and want in j_log
        assert os.listdir(tmp / f"port_{trainer}") == ["log.txt"]


def test_zero_shot_refuses_to_train(t_clip, tmp_path, monkeypatch):
    from rpo_tpu_torch.methods.zsclip import ZeroshotCLIP

    zs = ZeroshotCLIP(["cat", "dog"], "Synthetic", backbone="TINY", device="cpu",
                      clip_params=t_clip)
    with pytest.raises(RuntimeError, match="ZeroshotCLIP is evaluation-only"):
        zs.forward_backward({})
    with pytest.raises(NotImplementedError, match="RPO, CoOp, CoCoOp and LP"):
        zs.train_step(np.zeros((1, 32, 32, 3), np.uint8), [0], [1.0], 0.1)


def test_parse_results_equals_jax(runs, zero_shot, tmp_path, capsys):
    """The port's parse_results and the JAX package's on the logs both CLIs
    wrote: per-seed accuracies of training runs, and --hmean over a
    base-to-new layout of eval-only logs; the same printout."""
    train = tmp_path / "train"
    for i, out in enumerate((runs["jax_out"], runs["port_out"])):
        os.makedirs(train / f"seed{i + 1}")
        shutil.copy(os.path.join(out, "log.txt"), train / f"seed{i + 1}" / "log.txt")
    zs_tmp, _ = zero_shot
    hm = tmp_path / "b2n"
    for kind, trainer in (("base", "ZeroshotCLIP"), ("new", "ZeroshotCLIP2")):
        for i, pkg in enumerate(("jax", "port")):
            os.makedirs(hm / f"test_{kind}" / f"seed{i + 1}")
            shutil.copy(zs_tmp / f"{pkg}_{trainer}" / "log.txt",
                        hm / f"test_{kind}" / f"seed{i + 1}" / "log.txt")
    printed = {}
    for label, mod in (("jax", jparse), ("port", tparse)):
        outs = []
        for argv in ([str(train)], [str(hm), "--hmean"]):
            old = sys.argv
            sys.argv = ["parse_results", *argv]
            try:
                mod.main()
            finally:
                sys.argv = old
            outs.append(capsys.readouterr().out)
        printed[label] = outs
    assert printed["port"] == printed["jax"]
    acc = float(accuracy(runs["p_log"])[0])
    assert f"* accuracy: {acc:.2f}% +- 0.00%" in printed["port"][0]
    assert "* harmonic mean (H):" in printed["port"][1]
