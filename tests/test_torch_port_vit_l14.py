"""CLIP ViT-L/14 and ViT-L/14@336px in the port, on the CPU.

The two ``ARCHS`` entries at their published widths (OpenAI CLIP's
``clip/model.py`` ``build_model``, Radford et al. 2021, Table 20), the
converter's inference of them from state-dict shapes (no weights
allocated), the CLI naming the model, the checkpoint file names; RPO at a
small L/14-shaped configuration (patch 14, head dim 64 in both towers, 2
layers) against the benchmark's plain reference; the rect kernel's route
test and counters (``rpo_tpu_torch.tracing.count``); the benchmark's
readers of the counter and of the engine loop's ``loader_wait`` spans; and
the engine cell at TINY through the benchmark's harness.
"""
import importlib.util
import json
import os
import re
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import host_split, inputs
from benchmark.methods import rpo
from benchmark.methods.common import port_clip
from benchmark.reference.precision import EXACT
from benchmark.reference.sgd import leaves, train_steps
from rpo_tpu_torch import tracing
from rpo_tpu_torch.models.clip import convert
from rpo_tpu_torch.models.clip import pretrained as P
from rpo_tpu_torch.models.clip.model import ARCHS, VIT_L14, VIT_L14_336, CLIPConfig
from rpo_tpu_torch.ops import rect_attention as ra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["red fox", "oak", "great crested newt", "violin", "small dark owl"]
# the port's TINY widths (the engine cell's kind names the backbone by them)
TINY_CLIP = {"embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
             "vision_heads": 1, "vision_patch_size": 16, "context_length": 77,
             "vocab_size": 49408, "text_width": 64, "text_heads": 2, "text_layers": 2}
# ViT-L/14's shape at test size: 14-pixel patches (a 588-wide patch
# product), heads of 64 in both towers, two layers each
L14_SMALL = {"embed_dim": 64, "image_resolution": 42, "vision_layers": 2, "vision_width": 128,
             "vision_heads": 2, "vision_patch_size": 14, "context_length": 77,
             "vocab_size": 49408, "text_width": 128, "text_heads": 2, "text_layers": 2}


@pytest.fixture(autouse=True)
def empty_record():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("name,res,rows", [("ViT-L/14", 224, 257), ("ViT-L/14@336px", 336, 577)])
def test_the_archs_hold_the_published_widths(name, res, rows):
    cfg = ARCHS[name]
    assert cfg == CLIPConfig(embed_dim=768, image_resolution=res, vision_layers=24,
                             vision_width=1024, vision_patch_size=14, context_length=77,
                             vocab_size=49408, text_width=768, text_heads=12, text_layers=12)
    assert cfg.is_vit and cfg.vision_heads == 16 and cfg.vision_seq_len == rows
    assert cfg is (VIT_L14 if res == 224 else VIT_L14_336)


@pytest.mark.parametrize("name", ["ViT-L/14", "ViT-L/14@336px"])
def test_infer_config_gives_the_arch_back_from_its_shapes(name):
    """The converter reads each width from the state dict's shapes, as
    ``build_model`` does; the arrays are zero-stride views, so nothing of
    the 428M parameters is allocated."""
    shapes = convert.state_dict_shapes(ARCHS[name])
    sd = {k: np.broadcast_to(np.float32(0), s) for k, s in shapes.items()}
    assert convert.infer_config(sd) == ARCHS[name]
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert 427e6 < n < 429e6  # about 428M parameters


def test_the_cli_names_the_model():
    """``--opts MODEL.BACKBONE.NAME ViT-L/14@336px INPUT.SIZE "(336, 336)"``
    resolves to the arch, whose resolution the trainer's check compares
    with INPUT.SIZE, and RPO takes it (a ViT)."""
    from rpo_tpu_torch.cli import build_parser, setup_cfg
    from rpo_tpu_torch.methods.rpo_trainer import RPO

    args = build_parser().parse_args([
        "--trainer", "RPO", "--dataset-config-file",
        os.path.join(REPO, "configs/datasets/synthetic.yaml"), "--config-file",
        os.path.join(REPO, "configs/trainers/RPO/main_K24.yaml"),
        "MODEL.BACKBONE.NAME", "ViT-L/14@336px", "INPUT.SIZE", "(336, 336)"])
    cfg = setup_cfg(args)
    arch = ARCHS[cfg.MODEL.BACKBONE.NAME]
    assert arch is VIT_L14_336 and int(cfg.INPUT.SIZE[0]) == arch.image_resolution
    RPO.check_cfg(RPO.__new__(RPO), cfg)  # no refusal: RPO needs a ViT


@pytest.mark.parametrize("name,openai,hf", [
    ("ViT-L/14", "ViT-L-14.pt", "clip-vit-large-patch14"),
    ("ViT-L/14@336px", "ViT-L-14-336px.pt", "clip-vit-large-patch14-336")])
def test_checkpoint_names(name, openai, hf, tmp_path, monkeypatch, capsys):
    """The OpenAI file name is found and loaded unchecked (no published
    hash at hand); without it, the HF repo's name."""
    monkeypatch.delenv("CLIP_CHECKPOINT", raising=False)
    monkeypatch.setenv("CLIP_CACHE_DIR", str(tmp_path))
    assert P.find_checkpoint(name) is None
    (tmp_path / f"{hf}.safetensors").write_bytes(b"x")
    assert P.find_checkpoint(name) == str(tmp_path / f"{hf}.safetensors")
    (tmp_path / openai).write_bytes(b"custom weights")
    assert P.find_checkpoint(name) == str(tmp_path / openai)
    assert "SHA256" not in capsys.readouterr().out
    assert name not in P._SHA256


def _l14_small(seed=7):
    config = json.loads(open(os.path.join(REPO, "benchmark/configs/rpo_vit_l14_336.json")).read())
    config.update(clip=L14_SMALL, prec="fp32")
    sd = inputs.state_dict(L14_SMALL, seed, "cpu", dtype=torch.float32)
    state = rpo.make_state(config, sd, seed + 1, "cpu")
    params, cfg = port_clip(config, sd, "cpu")
    assert (cfg.vision_heads, cfg.vision_seq_len, cfg.vision_patch_size ** 2 * 3) == (2, 10, 588)
    trainer = rpo.build_trainer(config, NAMES, params, cfg, "cpu")
    trainer.set_ckpt_state(rpo.MODEL, state)
    ref = rpo.reference(config, sd, NAMES)
    images = torch.from_numpy(inputs.image_pool(1, 4, 42, seed + 2, "cpu"))[0]
    return config, trainer, ref, state, images


def test_rpo_eval_logits_at_an_l14_shape_agree_with_the_reference():
    _, trainer, ref, state, images = _l14_small()
    with torch.no_grad():
        got = trainer.eval_step(images)
        want = ref.logits(state, images, EXACT)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


def test_rpo_train_step_at_an_l14_shape_agrees_with_the_reference():
    """One step's loss (within 1e-5) and prompt gradients (each within a
    thousandth of its norm) against the reference's autograd."""
    config, trainer, ref, state, images = _l14_small()
    labels = torch.from_numpy(inputs.labels_pool(1, 4, len(NAMES), 9))[0]
    loss, _, grads = trainer.loss_and_grads(images, labels, torch.ones(4))
    out = train_steps(lambda s, x: ref.logits(s, x, EXACT), state, [(images, labels)], 0.01,
                      config["momentum"], config["weight_decay"])
    assert abs(float(loss) - out["losses"][0]) <= 1e-5
    got = leaves(grads)
    assert set(got) == set(out["grad1"]) == {"text_prompt", "img_prompt"}
    for k, want in out["grad1"].items():
        assert float((got[k] - want).norm() / want.norm()) < 1e-3, k


# -- the rect kernel's route, and the counters --------------------------------

HEADER = os.path.join(REPO, "rpo_tpu_torch/ops/csrc/attention_tc.cuh")


def test_the_route_test_is_the_kernels_max_tiles():
    """``two_pass`` at the widest row held in registers and one key past
    it (256 | 257 keys at head dim 32, 128 | 129 at 128; at 64 the rows
    past 256 keys take the split-row route up to 624, and two passes from
    625), and ``max_tiles`` read against ``csrc/attention_tc.cuh``."""
    header = open(HEADER).read()
    m = re.search(r"constexpr int max_tiles\(int D\) \{ return D == 128 \? (\d+) : (\d+); \}",
                  header)
    assert m and (int(m.group(1)), int(m.group(2))) == (ra.max_tiles(128), ra.max_tiles(64))
    assert ra.max_tiles(32) == ra.max_tiles(64) == 16 and ra.max_tiles(128) == 8
    for D, widest in ((32, 256), (64, 624), (128, 128)):
        assert not ra.two_pass(widest, D) and ra.two_pass(widest + 1, D)
        assert not ra.two_pass(1, D)
    assert not ra.two_pass(256, 64) and not ra.two_pass(257, 64)
    assert not ra.two_pass(577, 64) and not ra.two_pass(197, 64) and ra.two_pass(768, 64)


def test_the_split_row_test_is_the_kernels():
    """``split_row``'s constants and condition read against
    ``csrc/attention_tc.cuh``: head dim 64, past ``max_tiles(64)`` tiles
    (257 keys) up to three warps of 13 tiles (624 keys), whose block fits
    the card's shared memory exactly; never at head dims 32 and 128."""
    header = open(HEADER).read()
    consts = dict(re.findall(r"constexpr int (kSplit\w+) = (\d+);", header))
    assert {k: int(v) for k, v in consts.items()} == {
        "kSplitSlice": ra._SPLIT_SLICE, "kSplitWarps": ra._SPLIT_WARPS,
        "kSplitGroups": ra._SPLIT_GROUPS} == {"kSplitSlice": 13, "kSplitWarps": 3,
                                              "kSplitGroups": 4}
    cond = re.search(r"inline bool split_row\(int D, int Lk, int max_smem\) \{\n"
                     r"  const int nkt = tiles\(Lk\);\n  return (.*?);\n\}", header, re.S)
    assert cond and " ".join(cond.group(1).split()) == (
        "D == 64 && nkt > max_tiles(D) && nkt <= kSplitWarps * kSplitSlice && "
        "split_smem_bytes(D, Lk) <= (size_t)max_smem")
    on = [Lk for Lk in range(1, 800) if ra.split_row(Lk, 64)]
    assert on == list(range(257, 625))
    assert ra.split_row(577, 64) and not ra.split_row(197, 64)
    assert not any(ra.split_row(Lk, D) for D in (32, 128) for Lk in range(1, 1500))
    assert ra._split_bytes(624, 64) == ra._MAX_SHARED


def test_count_stamps_instant_rows_under_the_innermost_span(monkeypatch):
    clock = iter(range(0, 100_000_000, 1_000_000))
    monkeypatch.setattr(tracing, "time_ns", lambda: next(clock))
    tracing.count("alone")
    with tracing.span("outer"):
        tracing.count("a")
        with tracing.span("inner"):
            tracing.count("b")
            tracing.count("b")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("profiled")
    rows = tracing.spans()
    assert [(s.name, s.parent, s.profiled) for s in rows] == [
        ("alone", -1, False), ("outer", -1, False), ("a", 1, False), ("inner", 1, False),
        ("b", 3, False), ("b", 3, False), ("profiled", -1, True)]
    assert all(s.start_ns == s.end_ns for s in rows if s.name not in ("outer", "inner"))
    summary = tracing.summary()
    assert summary["b"] == {"count": 2, "total_ms": 0.0, "self_ms": 0.0}
    assert summary["inner"]["self_ms"] == summary["inner"]["total_ms"]


def test_a_bf16_launch_stamps_its_route(monkeypatch):
    """The wrapper's launch stamps ``rect_split_row``, ``rect_two_pass`` or
    ``rect_registers`` for bf16 and nothing for f32 (the launch itself
    replaced: no card)."""
    class Lib:
        def rect_attention_forward(self, *args):
            return 0

    monkeypatch.setattr(ra, "_lib", lambda: Lib())
    monkeypatch.setattr(ra, "_stream", lambda device: 0)
    monkeypatch.setattr(ra, "_check", lambda q, k, v: None)
    before = ra.launches
    for Lk, dtype in ((577, torch.bfloat16), (197, torch.bfloat16), (257, torch.float32),
                      (257, torch.bfloat16), (625, torch.bfloat16), (768, torch.bfloat16)):
        kv = torch.zeros(1, 1, Lk, 64, dtype=dtype)
        ra._launch(torch.zeros(1, 1, 4, 64, dtype=dtype), kv, kv)
    assert ra.launches == before + 6
    assert [s.name for s in tracing.spans()] == ["rect_split_row", "rect_registers",
                                                 "rect_split_row", "rect_two_pass",
                                                 "rect_two_pass"]


def _reader(metric):
    path = os.path.join(REPO, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_the_train_span_metrics_read_the_same_with_counter_rows(monkeypatch):
    """Counter rows inside and between the dispatches (a capture's
    launches, say) change nothing the four train metrics read."""
    from tests.test_torch_port_tracing import READERS, reading, train_record

    rows = train_record()
    with_counts, at = [], {}  # at: a row's index in ``rows`` -> in ``with_counts``
    for i, row in enumerate(rows):
        at[i] = len(with_counts)
        with_counts.append(row[:3] + (at.get(row[3], -1),) + row[4:])
        if row[0] in ("stage_copy", "replay"):  # under the dispatch, and at the top level
            with_counts.append(("rect_two_pass", row[1], row[1], at[row[3]], row[4]))
            with_counts.append(("rect_registers", row[2], row[2], -1, row[4]))
    for metric, (kind, *_rest) in READERS.items():
        if kind != "train":
            continue
        read = _reader(metric)
        monkeypatch.setattr(host_split, "record", lambda: rows)
        plain = [read(reading(kind, steps=s)) for s in (4, 2, 11)]
        monkeypatch.setattr(host_split, "record", lambda: with_counts)
        assert [read(reading(kind, steps=s)) for s in (4, 2, 11)] == plain, metric
        assert None not in plain


def test_rect_two_pass_calls_reads_the_profiled_counter_rows(monkeypatch):
    read = _reader("rect_two_pass_calls.eval")
    rows = ([("rect_two_pass", 1, 1, -1, False)] * 50  # the window's, not read
            + [("rect_two_pass", 2, 2, -1, True)] * 48 + [("rect_registers", 3, 3, -1, True)] * 4)
    monkeypatch.setattr(tracing, "spans", lambda: rows)
    r = SimpleNamespace(kind="eval", trace=object(), traced_steps=2)
    assert read(r) == 24.0
    assert read(SimpleNamespace(kind="eval", trace=object(), traced_steps=5)) is None  # 9.6
    assert read(SimpleNamespace(kind="train", trace=object(), traced_steps=2)) is None
    assert read(SimpleNamespace(kind="eval", trace=None, traced_steps=2)) is None
    monkeypatch.setattr(tracing, "spans", lambda: rows[:50])
    assert read(r) == 0.0  # one pass everywhere
    monkeypatch.delattr(tracing, "count")  # a program without counters
    assert read(r) is None


def test_rect_split_row_calls_reads_the_profiled_counter_rows(monkeypatch):
    read = _reader("rect_split_row_calls.eval")
    rows = ([("rect_split_row", 1, 1, -1, False)] * 50  # the window's, not read
            + [("rect_split_row", 2, 2, -1, True)] * 48 + [("rect_two_pass", 3, 3, -1, True)] * 4)
    monkeypatch.setattr(tracing, "spans", lambda: rows)
    r = SimpleNamespace(kind="eval", trace=object(), traced_steps=2)
    assert read(r) == 24.0
    assert read(SimpleNamespace(kind="eval", trace=object(), traced_steps=5)) is None  # 9.6
    assert read(SimpleNamespace(kind="train", trace=object(), traced_steps=2)) is None
    assert read(SimpleNamespace(kind="eval", trace=None, traced_steps=2)) is None
    monkeypatch.setattr(tracing, "spans", lambda: rows[:50] + rows[-4:])
    assert read(r) == 0.0  # every wide row on two passes
    monkeypatch.delattr(ra, "split_row")  # a program without the route
    assert read(r) is None
    monkeypatch.undo()
    monkeypatch.setattr(tracing, "spans", lambda: rows)
    monkeypatch.delattr(tracing, "count")  # a program without counters
    assert read(r) is None


def test_loader_wait_reads_the_windows_waits(monkeypatch):
    read = _reader("loader_wait_ms.train")
    ms = 1_000_000
    rows = []
    for k in range(3):  # three steps, each a wait of k + 1 ms, then the wait that finds the end
        t = 100 * ms * k
        rows += [("loader_wait", t, t + (k + 1) * ms, -1, False),
                 ("train_dispatch", t + 5 * ms, t + 9 * ms, -1, False),
                 ("replay", t + 6 * ms, t + 7 * ms, 1, False)]
    rows += [("loader_wait", 400 * ms, 400 * ms + ms // 2, -1, False),
             ("loader_wait", 500 * ms, 510 * ms, -1, True),  # the traced epoch's, not read
             ("train_dispatch", 511 * ms, 512 * ms, -1, True)]
    monkeypatch.setattr(tracing, "spans", lambda: rows)
    r = SimpleNamespace(kind="engine_epoch", steps=3)
    assert read(r) == pytest.approx((1 + 2 + 3 + 0.5) / 3)
    assert read(SimpleNamespace(kind="engine_epoch", steps=4)) is None  # the record dropped one
    assert read(SimpleNamespace(kind="train", steps=3)) is None
    monkeypatch.setattr(tracing, "spans", lambda: [s for s in rows if s[0] != "loader_wait"])
    assert read(r) is None  # a program without the span


def test_the_epoch_loop_waits_on_the_loader_in_spans():
    """Each batch of an epoch and the end come out of ``loader_wait``
    spans, outside the dispatch; an epoch left early stops the loader."""
    from rpo_tpu_torch.engine.trainer import _waited

    closed = []

    def loader():
        try:
            yield from range(3)
        finally:
            closed.append(True)

    assert list(_waited(loader())) == [0, 1, 2]
    rows = tracing.spans()
    assert [(s.name, s.parent) for s in rows] == [("loader_wait", -1)] * 4
    it = _waited(loader())
    next(it)
    it.close()
    assert closed == [True, True]


# -- the engine cell at TINY, on the CPU --------------------------------------

def test_the_engine_cell_runs_and_agrees_at_tiny():
    """``rpo_vit_b16-engine_epoch_dr224``'s kind at TINY widths in float32:
    the tree, the engine's loader and epochs, the window, a traced epoch,
    ``loader_wait_ms.train`` read from the record it left, and the first
    three steps against the reference (losses within 1e-5, gradients and
    updates within a thousandth) while the control fails."""
    from benchmark.harness import Cell, run_cell
    from benchmark.kinds import engine_epoch
    from benchmark.spec import Spec

    spec = Spec()
    config = dict(spec.config("rpo_vit_b16"), clip=TINY_CLIP, prec="fp32")
    assert port_clip(config, inputs.state_dict(TINY_CLIP, 0, "cpu"), "cpu")[1] == ARCHS["TINY"]
    traffic = dict(spec.traffic("engine_epoch_dr224"), n_cls=6, shots=2, per_class=6, sources=3,
                   source_size=[50, 38], device_resize=32, num_workers=2)
    limits = {"loss_gap": 1e-5, "grad1_gap": 1e-3, "update_gap": 1e-3}
    cell = Cell("rpo_vit_b16-engine_epoch_dr224", config, traffic, limits, 2 ** 31 + 11,
                torch.device("cpu"), spec.method("rpo"), engine_epoch)
    result = run_cell(spec, cell, 0.2, True, time.time(), control=True)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] % 3 == 0 and result["attempted"] >= 3  # whole epochs of 3 steps
    # the reader over the record the run left (the cell has no entry yet: PERF.md §7)
    wait = _reader("loader_wait_ms.train")(SimpleNamespace(kind="engine_epoch",
                                                           steps=result["attempted"]))
    assert wait is not None and wait > 0
    assert not all(c["value"] <= c["limit"] for c in result["checks_control"].values())
