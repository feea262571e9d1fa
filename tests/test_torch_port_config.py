"""The port's config system, registries, logger and backbone loader
against the JAX package's.

``rpo_tpu_torch.engine.config.read_yaml`` stands in for PyYAML, which the
card's machine lacks: on every file under configs/ it must give what
``yaml.safe_load`` gives, types included (YAML 1.1 reads ``1e-5`` as a
string, which ``_decode`` turns into a float).  The merged trees must
equal ``rpo_tpu.engine``'s for every dataset x trainer pair.
"""
import glob
import os
import subprocess
import sys

import pytest
import torch
import yaml

from rpo_tpu.engine import get_cfg_default as jax_cfg
from rpo_tpu_torch.engine import DATASET_REGISTRY, TRAINER_REGISTRY
from rpo_tpu_torch.engine.config import CfgNode, get_cfg_default, read_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
DATASETS = [p for p in CONFIGS if p.startswith("configs/datasets/")]
TRAINERS = [p for p in CONFIGS if p.startswith("configs/trainers/")]
# tests/test_engine_e2e.py's fixture opts
OPTS = ["DATASET.NUM_SHOTS", "4", "DATASET.SUBSAMPLE_CLASSES", "base", "OPTIM.MAX_EPOCH", "2",
        "MODEL.BACKBONE.NAME", "TINY", "INPUT.SIZE", "(32, 32)",
        "DATALOADER.TRAIN_X.BATCH_SIZE", "8", "DATALOADER.TEST.BATCH_SIZE", "16",
        "TRAINER.RPO.PREC", "fp32"]


def typed(tree):
    """A tree with each leaf beside its type: equal trees of equal types."""
    if isinstance(tree, dict):
        return {k: typed(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [typed(v) for v in tree])
    return (type(tree).__name__, tree)


@pytest.mark.parametrize("path", CONFIGS)
def test_read_yaml_equals_pyyaml(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    assert typed(read_yaml(text)) == typed(yaml.safe_load(text))


EDGE_DOC = """\
# a comment line
A:
  B: 1   # a trailing comment
  C: "x # not a comment"
  D: 'it''s'
  E: [1, 2.5, "a", b, 1e-5, 1.0e-5, yes, null, ~, 0x1F, 010, -3, +4, .5, 1_000, Off]
  F:
  G: "esc \\"q\\" \\\\ \\t"

H: (224, 224)
I: True
J: -.inf
K: []
L:
    M:
      N: -1.5
    O: plain text, with a comma
P: 0.0
"""


def test_read_yaml_edge_cases_equal_pyyaml():
    assert typed(read_yaml(EDGE_DOC)) == typed(yaml.safe_load(EDGE_DOC))
    assert read_yaml("") is None and yaml.safe_load("") is None


@pytest.mark.parametrize("doc", ["O: a: b", "- x", "A: {a: 1}", "A: &x 1", "A: |", "A: !t 1",
                                 "A:\n\tB: 1", "A: [1, [2]]", 'A: "x', "A:\n  B: 1\n C: 2"])
def test_read_yaml_refuses_what_it_does_not_read(doc):
    with pytest.raises(ValueError):
        read_yaml(doc)


@pytest.mark.parametrize("trainer", TRAINERS)
def test_merged_trees_equal_jax(trainer):
    """defaults <- each dataset yaml <- this trainer yaml <- the e2e opts,
    frozen: the same tree as rpo_tpu.engine's, values and types."""
    assert typed(get_cfg_default()) == typed(jax_cfg())
    for dataset in DATASETS:
        trees = []
        for get in (get_cfg_default, jax_cfg):
            cfg = get()
            cfg.merge_from_file(os.path.join(REPO, dataset))
            cfg.merge_from_file(os.path.join(REPO, trainer))
            cfg.merge_from_list(OPTS)
            cfg.freeze()
            trees.append(typed(cfg))
        assert trees[0] == trees[1], (dataset, trainer)


def test_merge_semantics():
    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(REPO, "configs/trainers/RPO/main_K24.yaml"))
    assert cfg.OPTIM.WARMUP_CONS_LR == 1e-5 and isinstance(cfg.OPTIM.WARMUP_CONS_LR, float)
    assert cfg.INPUT.SIZE == (224, 224) and cfg.TRAINER.RPO.K == 24
    with pytest.raises(ValueError, match="Type mismatch"):
        cfg.merge_from_list(["DATALOADER.TRAIN_X.BATCH_SIZE", "64.5"])
    with pytest.raises(ValueError, match="Type mismatch"):
        cfg.merge_from_list(["TRAINER.COOP.CTX_INIT", "None"])
    with pytest.raises(KeyError):
        cfg.merge_from_list(["DATASET.NO_SUCH_KEY", "1"])
    cfg.merge_from_list(["OPTIM.LR", "1", "MODEL.BACKBONE.NAME", "16"])
    assert cfg.OPTIM.LR == 1.0 and cfg.MODEL.BACKBONE.NAME == "16"
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.SEED = 3
    with pytest.raises(AttributeError):
        cfg.merge_from_list(["SEED", "3"])
    clone = cfg.clone()
    assert isinstance(clone, CfgNode) and clone.is_frozen()
    clone.defrost()
    clone.SEED = 7
    assert cfg.SEED == -1


def test_registries_and_unported_names(tmp_path):
    from rpo_tpu_torch.data.manager import DataManager
    import rpo_tpu_torch.methods.rpo_trainer  # noqa: F401  the package registers all six

    assert TRAINER_REGISTRY.registered_names() == [
        "CoCoOp", "CoOp", "LP", "RPO", "ZeroshotCLIP", "ZeroshotCLIP2"]
    assert DATASET_REGISTRY.registered_names() == ["Synthetic"]
    with pytest.raises(KeyError, match="Unknown trainer: 'MaPLe'"):
        TRAINER_REGISTRY.get("MaPLe")
    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(REPO, "configs/datasets/oxford_pets.yaml"))
    with pytest.raises(KeyError, match=r"not ported yet; ported: \['Synthetic'\]"):
        DataManager(cfg)


def _rpo_cfg(tmp_path, *opts):
    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(REPO, "configs/datasets/synthetic.yaml"))
    cfg.merge_from_file(os.path.join(REPO, "configs/trainers/RPO/main.yaml"))
    cfg.merge_from_list(["OUTPUT_DIR", str(tmp_path), "TRAINER.NAME", "RPO", *OPTS, *opts])
    return cfg


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """A ResNet backbone for RPO and a missing $CLIP_CHECKPOINT each raise
    at build; neither carries on (an existing checkpoint is loaded, its
    config inferred from its shapes).  INPUT.DEVICE_RESIZE, ported since, builds: its eval
    sources (S, S) and its train batches' {img, box, flip} take the
    device-resize routes of the trainer's image prep, and a non-bicubic
    interpolation with it raises."""
    from rpo_tpu.models.clip import pretrained as jpretrained
    from rpo_tpu_torch.engine import build_trainer
    from rpo_tpu_torch.models.clip import convert as tconvert
    import rpo_tpu_torch.methods.rpo_trainer  # noqa: F401

    monkeypatch.delenv("RPO_TPU_ALLOW_DOWNLOAD", raising=False)
    trainer = build_trainer(_rpo_cfg(tmp_path, "INPUT.DEVICE_RESIZE", "64"), device="cpu")
    assert trainer.dm.train_loader_x.transform.device_resize == 64
    src = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    assert tuple(trainer._normalize(src).shape) == (2, 32, 32, 3)
    train = {"img": src, "box": torch.tensor([[0, 0, 64, 64], [8, 4, 40, 30]], dtype=torch.int32),
             "flip": torch.tensor([0, 1], dtype=torch.int32)}
    assert tuple(trainer._normalize(train).shape) == (2, 32, 32, 3)
    with pytest.raises(ValueError, match="DEVICE_RESIZE requires"):
        build_trainer(_rpo_cfg(tmp_path, "INPUT.DEVICE_RESIZE", "64", "INPUT.INTERPOLATION",
                               "bilinear"), device="cpu")
    with pytest.raises(ValueError, match="requires a ViT backbone"):
        build_trainer(_rpo_cfg(tmp_path, "MODEL.BACKBONE.NAME", "TINY_RN"), device="cpu")
    # a missing $CLIP_CHECKPOINT raises JAX's FileNotFoundError, never
    # falling through to other weights; an existing one is loaded
    missing = str(tmp_path / "ViT-B-16.pt")
    monkeypatch.setenv("CLIP_CHECKPOINT", missing)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        build_trainer(_rpo_cfg(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        jpretrained.find_checkpoint("ViT-B/16")
    from tests.test_torch_port_convert import save_checkpoint

    save_checkpoint(missing, "TINY", seed=5)
    trainer = build_trainer(_rpo_cfg(tmp_path), device="cpu")
    want, _ = tconvert.load_clip(missing, device="cpu")
    assert torch.equal(trainer.clip_params["visual"]["patch_embed"],
                       want["visual"]["patch_embed"])
    assert trainer.clip_cfg.text_heads == 1  # inferred from the file: 64 // 64
    monkeypatch.delenv("CLIP_CHECKPOINT")
    with pytest.raises(ValueError, match="clip_imsize"):
        build_trainer(_rpo_cfg(tmp_path, "INPUT.SIZE", "(224, 224)"), device="cpu")


def test_load_backbone_is_the_seeded_random_init(capsys):
    from rpo_tpu_torch.models.clip import ARCHS, init_clip
    from rpo_tpu_torch.models.clip.pretrained import load_backbone

    params, cfg = load_backbone("TINY", seed=3, device="cpu")
    assert cfg is ARCHS["TINY"] and "RANDOM weights" in capsys.readouterr().out
    want = init_clip(torch.Generator().manual_seed(3), cfg)
    for key in ("patch_embed", "class_embedding", "positional_embedding"):
        torch.testing.assert_close(params["visual"][key], want["visual"][key], rtol=0, atol=0)
    assert params["visual"]["patch_embed"].dtype == torch.float32
    with pytest.raises(KeyError, match="Unknown backbone"):
        load_backbone("ViT-Z/1", device="cpu")


@pytest.mark.parametrize("old_log", [False, True])
def test_logger_tee_keeps_an_old_log(tmp_path, old_log):
    """log.txt gets everything printed; an existing log.txt is never
    touched, the new run writes log.txt-<timestamp> (Dassl)."""
    if old_log:
        (tmp_path / "log.txt").write_text("old run\n")
    code = (f"from rpo_tpu_torch.engine import setup_logger\n"
            f"setup_logger({str(tmp_path)!r})\nprint('hello tee')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "hello tee" in proc.stdout
    logs = sorted(os.listdir(tmp_path))
    if old_log:
        assert len(logs) == 2 and (tmp_path / "log.txt").read_text() == "old run\n"
        new = [name for name in logs if name != "log.txt"][0]
        assert new.startswith("log.txt-") and "hello tee" in (tmp_path / new).read_text()
    else:
        assert logs == ["log.txt"] and "hello tee" in (tmp_path / "log.txt").read_text()
