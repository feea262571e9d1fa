"""The port's data parallelism across gloo ranks against rpo_tpu's mesh.

One world of 2 and one of 4 gloo ranks on the CPU, each spawned once for
this file (``tests/torch_port_dist_workers.py``: the ranks import
neither jax nor rpo_tpu), run every case with the trainer's own steps on
their rows of the global batches; the parent holds each rank's results
against the JAX package on the 8 virtual CPU devices of
``tests/conftest.py``: ``rpo_tpu.parallel.dp``'s steps on a 2- and
4-device mesh and JAX's single-device step, on the same numpy-seeded
batches and the same weights (``params_from_numpy``).

- RPO (TINY): three train steps on a batch padded to the mesh (5 real
  rows of 8 at 4 ranks: one rank holds a real row and a padded one, one
  only padding), a grouped dispatch of two batches, the eval step's
  gathered logits from the first prompts (JAX's
  ``shard_eval_step_local``), in float32 at both worlds and bfloat16 at 2;
- padded rows do not move the step (JAX's
  ``test_padded_rows_do_not_change_grads``): 4 real rows against the same
  rows and 4 garbage ones masked out, where two of 4 ranks hold only
  padding;
- every rank's loader rows concatenate to ``rpo_tpu``'s padded global
  batch byte for byte, with and without INPUT.DEVICE_RESIZE;
- CoCoOp at batch 16 (each rank's chunks, then one all-reduce) against
  JAX's single-device accumulated step, not JAX's mesh (its accumulation
  is not legal there);
- ``tools/dryrun_multichip.py`` at 2 ranks, and the CLI under torchrun
  at 2 ranks against one process and ``rpo_tpu.cli`` on a 2-device mesh.

Tolerances, JAX's (``__graft_entry__.py``, tests/test_data_parallel.py):
float32 rtol 1e-5 / atol 1e-6 for prompts and loss, logits 1e-5;
bfloat16 1e-2 for prompts and loss.  bf16 logits: a rank's rows are a
smaller batch, whose products the CPU's BLAS blocks otherwise, so bf16
roundings flip; they are held to 0.15, tests/test_torch_port_rpo_train.py's
port-against-JAX bf16 bound.  A momentum is a gradient summed over the
rows in another order: float32 within 1e-5 + 1e-4 * its largest entry,
as that file holds gradients; bfloat16 within 1e-5 + 0.1 * its largest
entry (``tools/dryrun_multichip.py``'s bound), which a step on half the
batch or a step that makes no update breaks where the 1e-2 bound on the
prompts, about half a prompt's size, does not.
"""
import os
import random
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rpo_tpu.data.transforms import device_normalize_fn as jax_normalize
from rpo_tpu.engine.optim import sgd_init
from rpo_tpu.methods import rpo as jcore
from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
from rpo_tpu.models.clip import ARCHS, cast_params, init_clip
from rpo_tpu.parallel import dp as jdp
from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from tests import torch_port_dist_workers as workers
from tests.test_torch_port_cocoop_train import _batch as cocoop_batch
from tests.test_torch_port_cocoop_train import _case as cocoop_case
from tests.test_torch_port_cocoop_train import CLASSNAMES as COCOOP_CLASSES, N_CTX, LR as COCOOP_LR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSNAMES = [f"class {i}" for i in range(6)]
K = 3
LR = 0.01
F32 = dict(rtol=1e-5, atol=1e-6)
F32_LOGITS = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)
BF16_LOGITS_ATOL = 0.15
GRAD_REL = 1e-4
BF16_GRAD_REL = 0.1
STUB = types.SimpleNamespace(_momentum=0.9, _weight_decay=5e-4, _nesterov=False, _dampening=0.0)
PREC = {"float32": "fp32", "bfloat16": "fp16"}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
WORLDS = (2, 4)
LOADER_OPTS = ["DATASET.NUM_SHOTS", "4", "DATASET.SUBSAMPLE_CLASSES", "base",
               "MODEL.BACKBONE.NAME", "TINY", "INPUT.SIZE", "(32, 32)",
               "DATALOADER.TRAIN_X.BATCH_SIZE", "5", "DATALOADER.TEST.BATCH_SIZE", "7",
               "DATALOADER.NUM_WORKERS", "2"]
LOADER_CASES = {"host": [], "device_resize": ["INPUT.DEVICE_RESIZE", "16"]}


def _batch(seed, B, n_real):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, len(CLASSNAMES), B).astype(np.int64)
    mask = (np.arange(B) < n_real).astype(np.float32)
    return images, labels, mask


class Rpo:
    """The JAX side of one RPO case: weights, prompts, the steps."""

    def __init__(self, dtype):
        cfg = ARCHS["TINY"]
        self.dtype = dtype
        self.jp = cast_params(init_clip(jax.random.PRNGKey(0), cfg), JDT[dtype])
        self.task = jcore.make_task(cfg, CLASSNAMES, "a photo of a _.", K)
        self.prompts = jcore.init_prompts(jax.random.PRNGKey(1), self.jp, cfg, K)
        self.frozen = jcore.make_frozen(self.jp, self.task)
        normalize = jax_normalize(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=JDT[dtype])
        task = self.task
        self.step = JaxTrainer._make_train_step(
            STUB, lambda p, fr, u8, text_f: jcore.rpo_logits(
                p, fr, task, normalize(u8), text_f=text_f, split_vision=True),
            precompute=lambda p, fr: jcore.encode_text_with_prompts(p, fr, task))

        def multi(params, state, frozen, imgs, labels, mask, lr):
            def body(carry, batch):
                p, o, l, a = self.step(*carry, frozen, *batch, lr)
                return (p, o), l
            (params, state), losses = jax.lax.scan(body, (params, state), (imgs, labels, mask))
            return params, state, losses

        self.multi = multi
        self.eval = lambda p, fr, text_f, u8: jcore.rpo_logits(p, fr, task, normalize(u8),
                                                               text_f=text_f)

    def spec(self):
        return {"method": "RPO", "arch": "TINY", "prec": PREC[self.dtype], "K": K,
                "classnames": CLASSNAMES, "prompts": _np(self.prompts),
                "clip": _np(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), self.jp))}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


def _ops(world):
    B = jdp.pad_multiple(5, world)  # 5 real rows
    steps = [_batch(10 + i, B, 5) for i in range(3)]
    group = [dict(zip(("img", "label", "mask"), _batch(20 + i, 2 * world, 2 * world - 1)))
             for i in range(2)]
    evals = _batch(30, 4 * world, 4 * world)[0]
    exact = _batch(40, 4, 4)
    images = np.concatenate([exact[0], np.full((4, 32, 32, 3), 255, np.uint8)])
    padded = (images, np.concatenate([exact[1], np.zeros(4, np.int64)]),
              np.concatenate([exact[2], np.zeros(4, np.float32)]))
    return steps, group, evals, exact, padded


_RPO = {}


def rpo(dtype):
    if dtype not in _RPO:
        _RPO[dtype] = Rpo(dtype)
    return _RPO[dtype]


def _jobs(world):
    jobs = []
    for dtype in ("float32",) + (("bfloat16",) if world == 2 else ()):
        steps, group, evals, exact, padded = _ops(world)
        ops = [("step", *b, LR) for b in steps] + [
            ("group", group, LR), ("reset", _np(rpo(dtype).prompts)), ("eval", evals)]
        if dtype == "float32":
            ops += [("step", *exact, 0.05), ("reset", _np(rpo(dtype).prompts)),
                    ("step", *padded, 0.05)]
        jobs.append((f"rpo-{dtype}", "trainer", rpo(dtype).spec(), ops))
    c = cocoop_case("float32")
    images, labels, mask = cocoop_batch(16, 3, seed=16)
    jobs.append(("cocoop", "trainer", {
        "method": "CoCoOp", "arch": "TINY", "prec": "fp32", "classnames": COCOOP_CLASSES,
        "kwargs": {"n_ctx": N_CTX}, "prompts": c["params"],
        "clip": _np(c["jp"])}, [("step", images, labels.astype(np.int64), mask, COCOOP_LR)]))
    for name, extra in LOADER_CASES.items():
        jobs.append((f"loader-{name}", "loader", LOADER_OPTS + extra, None))
    return jobs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's results: {world: {job: [rank results]}}, spawned once."""
    return {w: workers.run_world(w, _jobs(w), tmp_path_factory.mktemp(f"world{w}"))
            for w in WORLDS}


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=what, **tol)


def _tree_close(got, want, tol, what):
    for key in want:
        _close(got[key], np.asarray(want[key], np.float32), tol, f"{what} {key}")


def _gradient_close(got, want, what, rel=GRAD_REL):
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key], np.float32)
        err, big = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 1e-5 + rel * big, f"{what} {key}: max err {err} at max {big}"


_STEPS = {}


def _jax_steps(case, mesh, batches, lr):
    """JAX's losses, accuracies, prompts and momenta after each step: the
    single-device jit, or ``shard_train_step`` on ``mesh`` (each made once)."""
    key = (case.dtype, None if mesh is None else mesh.devices.size)
    if key not in _STEPS:
        _STEPS[key] = (jax.jit(case.step) if mesh is None
                       else jdp.shard_train_step(case.step, mesh, donate=False))
    fn = _STEPS[key]
    params, state, out = case.prompts, sgd_init(case.prompts), []
    for images, labels, mask in batches:
        params, state, loss, acc = fn(params, state, case.frozen, jnp.asarray(images),
                                      jnp.asarray(labels, jnp.int32), jnp.asarray(mask),
                                      jnp.float32(lr))
        out.append((float(loss), float(acc), _np(params), _np(state.momentum), state))
    return out, params, state


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("oracle", ["mesh", "single device"])
def test_rpo_train_steps_equal_jax(worlds, world, oracle):
    case = rpo("float32")
    steps = _ops(world)[0]
    mesh = jdp.make_mesh(jax.devices()[:world]) if oracle == "mesh" else None
    want, _, _ = _jax_steps(case, mesh, steps, LR)
    for r, results in enumerate(worlds[world]["rpo-float32"]):
        for i, (got, (loss, acc, params, momentum, _)) in enumerate(zip(results[:3], want)):
            what = f"rank {r} step {i}"
            _close(got["loss"], loss, F32, f"{what} loss")
            assert got["acc"] == pytest.approx(acc), what
            _tree_close(got["params"], params, F32, f"{what} prompts")
            _gradient_close(got["momentum"], momentum, f"{what} momentum")


def test_rpo_bf16_train_step_equals_jax_mesh(worlds):
    case = rpo("bfloat16")
    want, _, _ = _jax_steps(case, jdp.make_mesh(jax.devices()[:2]), _ops(2)[0], LR)
    for results in worlds[2]["rpo-bfloat16"]:
        for got, (loss, _, params, momentum, _) in zip(results[:3], want):
            _close(got["loss"], loss, BF16, "bf16 loss")
            _tree_close(got["params"], params, BF16, "bf16 prompts")
            _gradient_close(got["momentum"], momentum, "bf16 momentum", BF16_GRAD_REL)


@pytest.mark.parametrize("world", WORLDS)
def test_grouped_step_equals_jax_shard_multi_step(worlds, world):
    case = rpo("float32")
    steps, group, _, _, _ = _ops(world)
    _, params, state = _jax_steps(case, None, steps, LR)
    stack = lambda key, dt: jnp.asarray(np.stack([b[key] for b in group]), dt)  # noqa: E731
    mesh = jdp.make_mesh(jax.devices()[:world])
    p, _, losses = jdp.shard_multi_step(case.multi, mesh, donate=False)(
        params, state, case.frozen, stack("img", jnp.uint8), stack("label", jnp.int32),
        stack("mask", jnp.float32), jnp.float32(LR))
    for results in worlds[world]["rpo-float32"]:
        got = results[3]
        _close(got["losses"], np.asarray(losses), F32, "grouped losses")
        _tree_close(got["params"], _np(p), F32, "grouped prompts")


@pytest.mark.parametrize("world,dtype", [(2, "float32"), (4, "float32"), (2, "bfloat16")])
def test_eval_local_and_gathered_equals_jax(worlds, world, dtype):
    """Every rank ends with the whole batch's logits, JAX's per-device
    local eval's (and the single-device program's); bf16 at 2 ranks."""
    case = rpo(dtype)
    evals, params = _ops(world)[2], case.prompts  # the eval runs from the first prompts
    text_f = jcore.encode_text_with_prompts(params, case.frozen, case.task)
    mesh = jdp.make_mesh(jax.devices()[:world])
    local = jdp.shard_eval_step_local(case.eval, mesh)(params, case.frozen, text_f,
                                                       jnp.asarray(evals))
    single = jax.jit(case.eval)(params, case.frozen, text_f, jnp.asarray(evals))
    for results in worlds[world][f"rpo-{dtype}"]:
        got = results[5]["logits"]
        assert got.shape == (len(evals), len(CLASSNAMES))
        for want in (local, single):
            if dtype == "float32":
                _close(got, np.asarray(want), F32_LOGITS, "logits")
            else:
                assert np.abs(got - np.asarray(want, np.float32)).max() <= BF16_LOGITS_ATOL


@pytest.mark.parametrize("world", WORLDS)
def test_padded_rows_do_not_change_the_step(worlds, world):
    """4 real rows, then the same rows and 4 garbage rows masked out (two
    of 4 ranks hold only padding: their local mask total is 0): the same
    loss and prompts, within JAX's bounds for this property."""
    for results in worlds[world]["rpo-float32"]:
        exact, padded = results[6], results[8]  # each from the first prompts
        _close(padded["loss"], exact["loss"], dict(rtol=1e-6, atol=0), "loss")
        _tree_close(padded["params"], exact["params"], dict(rtol=1e-5, atol=1e-7), "prompts")
        case = rpo("float32")
        want, _, _ = _jax_steps(case, None, [_ops(world)[3]], 0.05)
        _tree_close(exact["params"], want[0][2], F32, "prompts against JAX")


def _jax_epochs(opts, world, monkeypatch):
    from rpo_tpu.engine import get_cfg_default  # before the manager: a cycle
    from rpo_tpu.data.manager import DataManager
    import rpo_tpu.data.datasets  # noqa: F401  registers the JAX datasets

    monkeypatch.setattr(jax, "device_count", lambda: world)
    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(REPO, "configs/datasets/synthetic.yaml"))
    cfg.merge_from_file(os.path.join(REPO, "configs/trainers/RPO/main.yaml"))
    cfg.merge_from_list(opts)
    cfg.freeze()
    random.seed(1)
    np.random.seed(1)
    dm = DataManager(cfg)
    return {(epoch, split): [dict(b) for b in getattr(dm, split)]
            for epoch in range(2) for split in ("train_loader_x", "test_loader")}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("loader", list(LOADER_CASES))
def test_loader_rows_concatenate_to_the_padded_global_batch(worlds, world, loader,
                                                            monkeypatch):
    """Each rank decodes its rows of the batch padded to a multiple of the
    ranks (train 5 -> 6 | 8, test 7 -> 8); in rank order they are
    rpo_tpu's padded global batch, image bytes included, over two epochs."""
    want = _jax_epochs(LOADER_OPTS + LOADER_CASES[loader], world, monkeypatch)
    ranks = worlds[world][f"loader-{loader}"]
    assert all(r.keys() == want.keys() for r in ranks)
    n_batches = 0
    for key, batches in want.items():
        for i, batch in enumerate(batches):
            parts = [r[key][i] for r in ranks]
            assert all(p["n"] == batch["n"] for p in parts), key
            assert len(parts[0]["label"]) * world == len(batch["label"])
            for field in ("img", "label", "mask") + (("box", "flip") if "box" in batch else ()):
                got = np.concatenate([p[field] for p in parts])
                assert got.dtype == batch[field].dtype and np.array_equal(got, batch[field]), \
                    (key, i, field)
            if key[1] == "test_loader":  # the evaluator's labels beside the gathered logits
                assert all(np.array_equal(p["all_label"], batch["label"]) for p in parts)
            n_batches += 1
    assert n_batches > 8


@pytest.mark.parametrize("world", WORLDS)
def test_cocoop_batch16_equals_jax_single_device(worlds, world):
    """Each rank accumulates over the chunks of its own rows (8 or 4),
    then one all-reduce: JAX's single-device accumulated step (chunks of
    8), whose scan over a sharded batch JAX's mesh cannot run."""
    c = cocoop_case("float32")
    images, labels, mask = cocoop_batch(16, 3, seed=16)
    _, (new, state, loss, acc) = c["run"](images, labels, mask, "accumulated")
    for results in worlds[world]["cocoop"]:
        got = results[0]
        _close(got["loss"], float(loss), F32, "loss")
        assert got["acc"] == pytest.approx(float(acc))
        for key in ("ctx",):
            _close(got["params"][key], np.asarray(new[key]), F32, key)
        for key, leaf in new["meta_net"].items():
            _close(got["params"]["meta_net"][key], np.asarray(leaf), F32, f"meta_net {key}")


def test_dryrun_multichip_two_ranks():
    """The tool at 2 ranks on the CPU: every check holds, one JSON line."""
    from rpo_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    out = dryrun_multichip(2)
    assert out["ok"], out["faults"]
    assert set(out["checks"]) == {"dp-fp32", "dp-fp16", "device-augment", "microbatch", "tp"}


CLI_ARGS = ["--seed", "1", "--trainer", "RPO",
            "--dataset-config-file", "configs/datasets/synthetic.yaml",
            "--config-file", "configs/trainers/RPO/main.yaml",
            "DATASET.NUM_SHOTS", "4", "OPTIM.MAX_EPOCH", "1", "MODEL.BACKBONE.NAME", "TINY",
            "INPUT.SIZE", "(32, 32)", "DATALOADER.TRAIN_X.BATCH_SIZE", "5",
            "DATALOADER.TEST.BATCH_SIZE", "16", "TRAINER.RPO.PREC", "fp32",
            "TRAIN.PRINT_FREQ", "1", "DATALOADER.NUM_WORKERS", "2"]


def _run(cmd, env_extra):
    env = {**os.environ, "RPO_TPU_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           **env_extra}
    env.pop("RPO_TPU_ALLOW_DOWNLOAD", None)
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _losses(text):
    return [float(m) for m in re.findall(r"loss (\d+\.\d+) \(", text)]


def _accuracy(text):
    return re.search(r"\* accuracy: ([\d.]+)%", text).group(1)


def test_cli_under_torchrun_equals_one_process_and_jax_mesh(tmp_path):
    """``python -m rpo_tpu_torch.cli`` under torchrun at 2 ranks (gloo,
    batch 5 padded to 6): one log.txt, rank 0's, whose step losses and
    accuracy are the single process's and ``rpo_tpu.cli``'s on a 2-device
    mesh, all three from one TINY checkpoint (``$CLIP_CHECKPOINT``) and the
    same prompts (MODEL.INIT_WEIGHTS)."""
    import pickle

    from tests.test_torch_port_convert import save_checkpoint

    ckpt = {"CLIP_CHECKPOINT": save_checkpoint(tmp_path / "TINY.pt", "TINY", seed=1)}
    rng, cfg = np.random.RandomState(5), ARCHS["TINY"]
    with open(tmp_path / "prompts.pkl", "wb") as f:
        pickle.dump({"state_dict": {
            "text_prompt": (rng.randn(4, cfg.text_width) * 0.1).astype(np.float32),
            "img_prompt": (rng.randn(4, cfg.vision_width) * 0.1).astype(np.float32)}}, f)
    args = CLI_ARGS + ["MODEL.INIT_WEIGHTS", str(tmp_path / "prompts.pkl")]
    two = tmp_path / "two"
    _run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
          "-m", "rpo_tpu_torch.cli", "--output-dir", str(two)] + args, ckpt)
    log = (two / "log.txt").read_text()
    assert sorted(p.name for p in two.iterdir()) == ["log.txt", "prompt_learner"]
    assert "Multiple devices detected (n=2), data-parallel mesh over gloo" in log
    assert log.count("Finish training") == 1 and log.count("* accuracy:") == 1
    one = _run([sys.executable, "-m", "rpo_tpu_torch.cli", "--output-dir", str(tmp_path / "one")]
               + args, ckpt)
    jax_out = _run([sys.executable, "train.py", "--output-dir", str(tmp_path / "jax")] + args,
                   {**ckpt, "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    assert "Multiple devices detected (n=2)" in jax_out
    l2, l1, lj = _losses(log), _losses(one), _losses(jax_out)
    assert len(l2) == len(l1) == len(lj) == 8  # 40 items, 8 batches of 5
    np.testing.assert_allclose(l2, l1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(l2, lj, rtol=1e-4, atol=1e-5)
    assert _accuracy(log) == _accuracy(one) == _accuracy(jax_out)
