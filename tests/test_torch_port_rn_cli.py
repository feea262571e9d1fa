"""The ModifiedResNet protocol through the port's CLI against the JAX
package's: CoOp's ``rn50_ep50.yaml`` (float32 and bfloat16), zero-shot
CLIP, an LP step, RPO's refusal, and ``tools/classify.py``.

Both packages load one random TINY_RN checkpoint (OpenAI's layout, BN
statistics drawn, ``torch.save``d; ``tests/test_torch_port_convert.py``)
through ``$CLIP_CHECKPOINT``, and the trainers start from the same
trainable tensors (MODEL.INIT_WEIGHTS).  The runs are
``tests/test_torch_port_baselines_cli.py``'s: Synthetic's 5 base classes
x 4 shots at 32 x 32, seed 1, batch 8, two epochs, test batch 16, and
its tolerances (float32 losses within 1e-5; bfloat16 0.02 and the
gradient-like bounds of the saved movement and momentum; equal accuracy
lines).
"""
import contextlib
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest

from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu_torch import cli as tcli
from rpo_tpu_torch.methods.base_trainer import CLIPMethodTrainer as PortTrainer
from tests.test_torch_port_convert import save_checkpoint
from tests.test_torch_port_engine_run import (  # noqa: F401  (jax_cli is a fixture)
    PREC_DTYPE, _close_as_gradient, accuracy, jax_cli, run)
from tests.test_torch_port_rpo_train import TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 2
D = 64  # TINY_RN's text width and embed_dim
N_CTX = 4  # rn50_ep50.yaml leaves TRAINER.COOP at its defaults (N_CTX 4)


def common_args(out, trainer, config, extra=()):
    return ["--seed", "1", "--trainer", trainer,
            "--dataset-config-file", os.path.join(REPO, "configs/datasets/synthetic.yaml"),
            "--config-file", os.path.join(REPO, config), "--output-dir", out, *extra,
            "DATASET.NUM_SHOTS", "4", "DATASET.SUBSAMPLE_CLASSES", "base",
            "MODEL.BACKBONE.NAME", "TINY_RN", "INPUT.SIZE", "(32, 32)",
            "DATALOADER.TEST.BATCH_SIZE", "16", "DATALOADER.NUM_WORKERS", "2"]


def write_init(path, tree):
    tree = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    with open(path, "wb") as f:
        pickle.dump({"state_dict": tree, "epoch": 0}, f)
    return tree


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return save_checkpoint(tmp_path_factory.mktemp("rn_ckpt") / "RN50.pt", "TINY_RN", seed=1)


@contextlib.contextmanager
def both(checkpoint):
    """A MonkeyPatch with ``$CLIP_CHECKPOINT`` set and no download."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CLIP_CHECKPOINT", checkpoint)
    mp.delenv("RPO_TPU_ALLOW_DOWNLOAD", raising=False)
    mp.delenv("RPO_TPU_FORCE_CPU", raising=False)
    try:
        yield mp
    finally:
        mp.undo()


def coop_args(out, prec, init, extra=()):
    return common_args(out, "CoOp", "configs/trainers/CoOp/rn50_ep50.yaml", extra) + [
        "OPTIM.MAX_EPOCH", str(EPOCHS), "DATALOADER.TRAIN_X.BATCH_SIZE", "8",
        "TRAINER.COOP.PREC", prec, "MODEL.INIT_WEIGHTS", init, "TRAIN.PREWARM_COMPILE", "False"]


@pytest.fixture(scope="module", params=["fp32", "fp16"])
def coop(request, tmp_path_factory, jax_cli, checkpoint):
    prec = request.param
    tmp = tmp_path_factory.mktemp(f"rn_coop_{prec}")
    init_path = str(tmp / "init.pkl")
    init = write_init(init_path, {"ctx": np.random.RandomState(0).randn(N_CTX, D) * 0.02})
    with both(checkpoint) as mp:
        jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
        j_losses, j_log = run(jax_cli, JaxTrainer, coop_args(jax_out, prec, init_path), mp)
        mp.setenv("RPO_TPU_FORCE_CPU", "1")
        p_losses, p_log = run(tcli, PortTrainer, coop_args(port_out, prec, init_path), mp)
    return dict(prec=prec, dtype=PREC_DTYPE[prec], init=init, init_path=init_path,
                jax_out=jax_out, port_out=port_out, j_losses=j_losses, p_losses=p_losses,
                j_log=j_log, p_log=p_log)


def load_ckpt(out, name="prompt_learner", epoch=EPOCHS):
    with open(os.path.join(out, name, f"model.pth.tar-{epoch}"), "rb") as f:
        return pickle.load(f)


def test_coop_rn_step_losses_equal_jax(coop):
    assert len(coop["p_losses"]) == len(coop["j_losses"]) == EPOCHS * (20 // 8)
    np.testing.assert_allclose(coop["p_losses"], coop["j_losses"], rtol=0,
                               atol=TOL[coop["dtype"]]["loss"])
    for log in (coop["p_log"], coop["j_log"]):
        assert "Finish training" in log and " acc " in log
        assert "Initializing prompt_learner from" in log
        assert "Loading CLIP (backbone: TINY_RN) from " in log and "RN50.pt" in log


def test_coop_rn_saved_ctx_and_momentum_equal_jax(coop):
    j, p = load_ckpt(coop["jax_out"]), load_ckpt(coop["port_out"])
    assert p["epoch"] == j["epoch"] == EPOCHS
    assert set(p["state_dict"]) == set(j["state_dict"]) == {"ctx"}
    moved = {"ctx": p["state_dict"]["ctx"] - coop["init"]["ctx"]}
    want = {"ctx": j["state_dict"]["ctx"] - coop["init"]["ctx"]}
    _close_as_gradient(moved, want, coop["dtype"], "ctx movement")
    _close_as_gradient(p["optimizer"], j["optimizer"], coop["dtype"], "momentum")


def test_coop_rn_accuracy_equals_jax(coop):
    assert accuracy(coop["p_log"]) == accuracy(coop["j_log"])
    assert len(accuracy(coop["p_log"])) == 1


@pytest.mark.parametrize("trainer", ["ZeroshotCLIP", "ZeroshotCLIP2"])
def test_zero_shot_rn_equals_jax(trainer, tmp_path, jax_cli, checkpoint):
    with both(checkpoint) as mp:
        args = lambda side: common_args(  # noqa: E731
            str(tmp_path / side), trainer, "configs/trainers/CoOp/rn50.yaml", ["--eval-only"])
        _, j_log = run(jax_cli, JaxTrainer, args("jax"), mp)
        mp.setenv("RPO_TPU_FORCE_CPU", "1")
        _, p_log = run(tcli, PortTrainer, args("port"), mp)
    assert accuracy(p_log) == accuracy(j_log) and len(accuracy(p_log)) == 1
    assert "Finish training" not in p_log and os.listdir(tmp_path / "port") == ["log.txt"]


def test_lp_rn_step_equals_jax(tmp_path, jax_cli, checkpoint):
    """LP's first two steps on TINY_RN (batch 4, float32): the loss at the
    initial probe and after one update."""
    init_path = str(tmp_path / "init.pkl")
    rng = np.random.RandomState(0)
    write_init(init_path, {"w": np.eye(D) + rng.randn(D, D) * 0.05, "b": rng.randn(D) * 0.05})

    def args(side):
        return common_args(str(tmp_path / side), "LP",
                           "configs/trainers/LP/vit_b16_c4_ep10_batch1.yaml") + [
            "OPTIM.MAX_EPOCH", "1", "DATALOADER.TRAIN_X.BATCH_SIZE", "4",
            "TRAINER.LP.PREC", "fp32", "MODEL.INIT_WEIGHTS", init_path,
            "TRAIN.PREWARM_COMPILE", "False"]

    with both(checkpoint) as mp:
        j_losses, _ = run(jax_cli, JaxTrainer, args("jax"), mp)
        mp.setenv("RPO_TPU_FORCE_CPU", "1")
        p_losses, _ = run(tcli, PortTrainer, args("port"), mp)
    assert len(p_losses) == len(j_losses) == 5
    np.testing.assert_allclose(p_losses[:2], j_losses[:2], rtol=1e-5,
                               atol=1e-5 * max(1.0, abs(j_losses[0])))


def test_rpo_refuses_rn(tmp_path, monkeypatch):
    from rpo_tpu_torch.engine import build_trainer

    monkeypatch.setenv("RPO_TPU_FORCE_CPU", "1")
    cfg = tcli.setup_cfg(tcli.build_parser().parse_args(common_args(
        str(tmp_path), "RPO", "configs/trainers/RPO/main.yaml")))
    with pytest.raises(ValueError, match="RPO requires a ViT backbone"):
        build_trainer(cfg, device="cpu")


def _classify(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def test_classify_tool_equals_jax(tmp_path, jax_cli, checkpoint):
    """The port's ``tools/classify.py`` on synthetic:// images (no Pillow):
    the same top-3 classes as the JAX package's tool, the probabilities
    within 1e-3 (CoOp, float32, the same backbone and context)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import classify as jclassify
    finally:
        sys.path.pop(0)
    from rpo_tpu_torch.tools import classify as tclassify

    init_path = str(tmp_path / "init.pkl")
    write_init(init_path, {"ctx": np.random.RandomState(2).randn(N_CTX, D) * 0.5})
    images = [f"synthetic://{c}/{i}" for c, i in (("a", 0), ("b", 1), ("c", 2), ("d", 3))]
    argv = images + [
        "--trainer", "CoOp",
        "--dataset-config-file", os.path.join(REPO, "configs/datasets/synthetic.yaml"),
        "--config-file", os.path.join(REPO, "configs/trainers/CoOp/rn50_ep50.yaml"),
        "--top-k", "3", "--batch-size", "3", "--json",
        "MODEL.BACKBONE.NAME", "TINY_RN", "INPUT.SIZE", "(32, 32)", "TRAINER.COOP.PREC", "fp32",
        "MODEL.INIT_WEIGHTS", init_path]
    with both(checkpoint) as mp:
        want = _classify(jclassify.main, argv)
        mp.setenv("RPO_TPU_FORCE_CPU", "1")
        got = _classify(tclassify.main, argv)
    assert [r["image"] for r in got] == [r["image"] for r in want] == images
    for g, w in zip(got, want):
        assert [t["class"] for t in g["top"]] == [t["class"] for t in w["top"]]
        np.testing.assert_allclose([t["prob"] for t in g["top"]],
                                   [t["prob"] for t in w["top"]], rtol=0, atol=1e-3)
