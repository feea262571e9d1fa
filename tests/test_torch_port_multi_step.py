"""Grouped dispatch (TRAIN.STEPS_PER_DISPATCH), TRAIN.PREWARM_COMPILE and
the capture-safe SGD of the port, against itself and the JAX package.

On the CPU the engine's hooks run the eager steps one by one, the same
steps a CUDA graph captures on the card, so:

- the port's CLI at STEPS_PER_DISPATCH 3, over epochs of 5 steps (one
  full group and a trailing partial one), gives every loss and the saved
  prompts equal (``==``) to its run at 1, and at either PREWARM_COMPILE;
- at 3 it matches ``rpo_tpu.cli`` at 3 (whose full groups run one
  ``lax.scan``) at tests/test_torch_port_engine_run.py's tolerances, and
  with INPUT.DEVICE_RESIZE too;
- ``prewarm_plan`` equals the JAX one;
- the capture-safe ``engine.optim.SGD`` matches ``torch.optim.SGD`` and
  ``rpo_tpu.engine.optim.sgd_update`` over six steps at changing
  learning rates (first buffer, dampening, weight decay, nesterov), at
  tests/test_torch_port_optim.py's float32 tolerance (the update
  multiplies by the learning-rate tensor where torch fuses a multiply-add).

The ``gpu`` cases need a card and skip here: a graph's replays against
the eager steps from the same state (``torch.equal``), and a resume
under the graph.  This file imports JAX only inside the CPU tests, so the
``gpu`` cases run on the card's machine, which has no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_multi_step.py
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from rpo_tpu_torch import cli as tcli
from rpo_tpu_torch.engine import optim
from rpo_tpu_torch.methods import base_trainer as tbase
from rpo_tpu_torch.methods.base_trainer import CLIPMethodTrainer as PortTrainer
from rpo_tpu_torch.methods.step_graph import StepGraph, state_kept, train_batch_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4  # configs/trainers/RPO/main.yaml
SGD_TOL = dict(rtol=1e-6, atol=1e-7)  # tests/test_torch_port_optim.py's
SETTINGS = {
    "plain (RPO main)": dict(momentum=0.9, weight_decay=5e-4, nesterov=False, dampening=0.0),
    "nesterov": dict(momentum=0.9, weight_decay=5e-4, nesterov=True, dampening=0.0),
    "dampening, first-buffer rule": dict(momentum=0.9, weight_decay=5e-4, nesterov=False,
                                         dampening=0.3),
    "weight decay, no momentum": dict(momentum=0.0, weight_decay=0.1, nesterov=False,
                                      dampening=0.0),
    "nesterov without momentum": dict(momentum=0.0, weight_decay=5e-4, nesterov=True,
                                      dampening=0.0),
}
LRS = (0.01, 0.01, 0.005, 0.02, 1e-5, 0.01)


def run_args(out, prec="fp32", init=None, extra=(), device_resize=0, group=1, prewarm=True):
    """The engine tests' synthetic fixture at train batch 4: 20 base
    images, 5 steps an epoch, two epochs."""
    args = [
        "--seed", "1", "--trainer", "RPO",
        "--dataset-config-file", os.path.join(REPO, "configs/datasets/synthetic.yaml"),
        "--config-file", os.path.join(REPO, "configs/trainers/RPO/main.yaml"),
        "--output-dir", out, *extra,
        "DATASET.NUM_SHOTS", "4", "DATASET.SUBSAMPLE_CLASSES", "base",
        "OPTIM.MAX_EPOCH", "2", "MODEL.BACKBONE.NAME", "TINY", "INPUT.SIZE", "(32, 32)",
        "DATALOADER.TRAIN_X.BATCH_SIZE", "4", "DATALOADER.TEST.BATCH_SIZE", "16",
        "TRAINER.RPO.PREC", prec, "DATALOADER.NUM_WORKERS", "2",
        "TRAIN.STEPS_PER_DISPATCH", str(group), "TRAIN.PREWARM_COMPILE", str(prewarm),
        "INPUT.DEVICE_RESIZE", str(device_resize),
    ]
    return args + (["MODEL.INIT_WEIGHTS", init] if init else [])


def run(main_mod, trainer_cls, argv, monkeypatch, **build_kwargs):
    """One in-process CLI run: (every step's loss in order, the log text,
    the trainer).  Both hooks are recorded: a group's losses come back
    from ``forward_backward_multi``."""
    losses = []
    single, multi = trainer_cls.forward_backward, trainer_cls.forward_backward_multi

    def one(self, batch):
        summary = single(self, batch)
        losses.append(float(summary["loss"]))
        return summary

    def group(self, batches):
        summaries = multi(self, batches)
        losses.extend(float(s["loss"]) for s in summaries)
        return summaries

    monkeypatch.setattr(trainer_cls, "forward_backward", one)
    monkeypatch.setattr(trainer_cls, "forward_backward_multi", group)
    stdout = sys.stdout
    try:
        trainer = main_mod.main(main_mod.build_parser().parse_args(argv), **build_kwargs)
    finally:
        sys.stdout = stdout
        monkeypatch.setattr(trainer_cls, "forward_backward", single)
        monkeypatch.setattr(trainer_cls, "forward_backward_multi", multi)
    out = argv[argv.index("--output-dir") + 1]
    logs = sorted((p for p in os.listdir(out) if p.startswith("log.txt")),
                  key=lambda p: os.path.getmtime(os.path.join(out, p)))
    with open(os.path.join(out, logs[-1])) as f:  # a relaunch writes log.txt-<time>
        return losses, f.read(), trainer


def saved(out, epoch=2):
    with open(os.path.join(out, "prompt_learner", f"model.pth.tar-{epoch}"), "rb") as f:
        return pickle.load(f)


# -- on the CPU, the port against itself -------------------------------------

@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's CLI at STEPS_PER_DISPATCH 1 and 3, and 3 without
    PREWARM_COMPILE, on its own random TINY backbone."""
    tmp = tmp_path_factory.mktemp("multi_step")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RPO_TPU_FORCE_CPU", "1")
        for name, kw in {"single": dict(group=1), "grouped": dict(group=3),
                         "grouped, no prewarm": dict(group=3, prewarm=False)}.items():
            out = str(tmp / name.replace(", ", "_").replace(" ", "_"))
            losses, log, trainer = run(tcli, PortTrainer, run_args(out, **kw), mp)
            runs[name] = dict(out=out, losses=losses, log=log, trainer=trainer)
    return runs


def test_grouped_run_equals_single_step_run(port_runs):
    """Each epoch: one group of 3 through forward_backward_multi, the
    trailing 2 through forward_backward; the same steps in the same
    order, so the same numbers."""
    one, three = port_runs["single"], port_runs["grouped"]
    assert len(one["losses"]) == len(three["losses"]) == 10
    assert three["losses"] == one["losses"]
    a, b = saved(one["out"]), saved(three["out"])
    for part in ("state_dict", "optimizer"):
        for key in a[part]:
            np.testing.assert_array_equal(b[part][key], a[part][key], err_msg=f"{part} {key}")
    assert "no grouped step" not in three["log"]
    assert three["log"].count("batch [5/5]") == 2  # the epoch's last batch is logged


def test_prewarm_compile_gives_the_same_numbers(port_runs):
    """PREWARM_COMPILE prepares nothing on the CPU (the steps run
    eagerly): off or on, the same run."""
    a, b = port_runs["grouped"], port_runs["grouped, no prewarm"]
    assert a["losses"] == b["losses"]
    assert "Captured the train step" not in a["log"]
    assert a["trainer"]._graphs == {} and b["trainer"]._graphs == {}


def test_prewarm_plan_equals_jax():
    from rpo_tpu.methods.base_trainer import prewarm_plan as jax_plan

    for group in range(1, 6):
        for num_batches in range(0, 13):
            assert tbase.prewarm_plan(group, num_batches) == jax_plan(group, num_batches), (
                group, num_batches)


def test_train_batch_spec_is_the_loaders():
    """The spec the prewarm captures at is the spec of a real batch."""
    from rpo_tpu_torch.methods.step_graph import batch_spec

    host = {"img": np.zeros((4, 32, 32, 3), np.uint8), "label": np.zeros(4, np.int32),
            "mask": np.ones(4, np.float32), "n": 4}
    assert batch_spec(host) == train_batch_spec(4, 32)
    host.update(img=np.zeros((4, 16, 16, 3), np.uint8), box=np.zeros((4, 4), np.int32),
                flip=np.zeros(4, np.int32))
    assert batch_spec(host) == train_batch_spec(4, 32, 16)


# -- on the CPU, against the JAX package -------------------------------------

@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """JAX's seed-1 TINY backbone through the weight bridge, and the JAX
    init_prompts payload both runs start from (MODEL.INIT_WEIGHTS)."""
    import jax

    from rpo_tpu.methods import rpo as jcore
    from rpo_tpu.models.clip import ARCHS, init_clip
    from rpo_tpu_torch.models.clip import params_from_numpy

    tmp = tmp_path_factory.mktemp("multi_step_jax")
    jclip = init_clip(jax.random.PRNGKey(1), ARCHS["TINY"])
    prompts = jax.tree_util.tree_map(
        np.asarray, jcore.init_prompts(jax.random.PRNGKey(0), jclip, ARCHS["TINY"], K))
    init = str(tmp / "init_prompts.pkl")
    with open(init, "wb") as f:
        pickle.dump({"state_dict": prompts, "epoch": 0}, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RPO_TPU_XLA_CACHE", "0")  # read at import: no cache outside the run
        from rpo_tpu import cli as jax_cli
    t_clip = params_from_numpy(jax.tree_util.tree_map(np.asarray, jclip), "cpu")
    return dict(tmp=tmp, init=init, prompts=prompts, jax_cli=jax_cli, t_clip=t_clip)


@pytest.mark.parametrize("device_resize", [0, 16], ids=["host crops", "DEVICE_RESIZE 16"])
def test_grouped_run_equals_jax(jax_pair, device_resize, monkeypatch):
    """Both CLIs at STEPS_PER_DISPATCH 3 from the same backbone and
    prompts: every step loss within the float32 loss tolerance, the saved
    prompts' movement and momentum as a gradient, the same accuracy.
    With DEVICE_RESIZE 16 the sources are 16 x 16 and the crops, resize
    and flips run in the train step on both sides."""
    from rpo_tpu.methods.base_trainer import CLIPMethodTrainer as JaxTrainer
    from tests.test_torch_port_engine_run import _close_as_gradient, accuracy
    from tests.test_torch_port_rpo_train import TOL

    tmp, init = jax_pair["tmp"], jax_pair["init"]
    name = f"resize{device_resize}"
    jax_out, port_out = str(tmp / f"jax_{name}"), str(tmp / f"port_{name}")
    j_losses, j_log, _ = run(jax_pair["jax_cli"], JaxTrainer, run_args(
        jax_out, init=init, group=3, device_resize=device_resize), monkeypatch)
    monkeypatch.setenv("RPO_TPU_FORCE_CPU", "1")
    p_losses, p_log, _ = run(tcli, PortTrainer, run_args(
        port_out, init=init, group=3, device_resize=device_resize), monkeypatch,
        clip_params=jax_pair["t_clip"])
    assert len(p_losses) == len(j_losses) == 10
    np.testing.assert_allclose(p_losses, j_losses, rtol=0, atol=TOL["float32"]["loss"])
    j, p = saved(jax_out), saved(port_out)
    prompts = jax_pair["prompts"]
    _close_as_gradient({k: p["state_dict"][k] - prompts[k] for k in prompts},
                       {k: j["state_dict"][k] - prompts[k] for k in prompts}, "float32",
                       "prompt movement")
    _close_as_gradient(p["optimizer"], j["optimizer"], "float32", "momentum")
    assert accuracy(p_log) == accuracy(j_log) and len(accuracy(p_log)) == 1


@pytest.mark.parametrize("name", list(SETTINGS))
def test_capture_safe_sgd_equals_torch_sgd_and_jax(name):
    """Six steps at changing learning rates from one tree of params:
    params and momentum after each against torch.optim.SGD (foreach off)
    and the JAX sgd_update; the optimizer's tensors keep their storage."""
    import jax
    import jax.numpy as jnp

    from rpo_tpu.engine.optim import sgd_init, sgd_update

    kw = SETTINGS[name]
    rng = np.random.RandomState(0)
    p0 = {"text_prompt": rng.randn(3, 8).astype(np.float32),
          "meta_net": {"w1": rng.randn(8, 2).astype(np.float32),
                       "b1": rng.randn(2).astype(np.float32)}}
    mine = optim.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    ref = [torch.from_numpy(a.copy()) for a in optim.tree_leaves(p0)]
    ref_opt = torch.optim.SGD(ref, lr=0.0, foreach=False, momentum=kw["momentum"],
                              dampening=kw["dampening"], weight_decay=kw["weight_decay"],
                              nesterov=bool(kw["nesterov"] and kw["momentum"]))
    opt = optim.sgd(mine, **kw)
    storage = [t.data_ptr() for t in opt.state_tensors()]
    jp, state = jax.tree_util.tree_map(jnp.asarray, p0), sgd_init(p0)
    for step, lr in enumerate(LRS):
        g = optim.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), p0)
        optim.sgd_step(opt, mine, optim.tree_map(torch.from_numpy, g), lr)
        for p, gl in zip(ref, optim.tree_leaves(g)):
            p.grad = torch.from_numpy(gl)
        ref_opt.param_groups[0]["lr"] = lr
        ref_opt.step()
        jp, state = sgd_update(jp, jax.tree_util.tree_map(jnp.asarray, g), state, lr, **kw)
        for got, want in zip(optim.tree_leaves(mine), ref):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **SGD_TOL,
                                       err_msg=f"{name} step {step} vs torch.optim.SGD")
        optim.tree_map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), **SGD_TOL, err_msg=f"{name} step {step} vs JAX"), mine, jp)
        if kw["momentum"]:
            bufs = [ref_opt.state[p]["momentum_buffer"] for p in ref]
            for got, want in zip(optim.tree_leaves(optim.sgd_momentum(opt, mine)), bufs):
                np.testing.assert_allclose(got.numpy(), want.numpy(), **SGD_TOL)
    assert [t.data_ptr() for t in opt.state_tensors()] == storage
    opt.reset()
    assert all(float(t.abs().max()) == 0 for t in optim.tree_leaves(optim.sgd_momentum(opt, mine)))
    assert [t.data_ptr() for t in opt.state_tensors()] == storage


def test_sgd_refuses_other_parameter_tensors():
    params = {"a": torch.zeros(3)}
    opt = optim.sgd(params)
    with pytest.raises(ValueError, match="other parameter tensors"):
        opt.update({"a": torch.zeros(3)}, {"a": torch.ones(3)})


# -- the graph runner and the state it captures --------------------------------

def test_graph_runner_refuses_a_cpu_device():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        StepGraph(lambda *a: (torch.zeros(()), torch.zeros(())), 1, train_batch_spec(4, 32),
                  lambda: [], "cpu")


def test_state_kept_restores_in_place():
    a, b = torch.arange(4.0), torch.ones(2, 2)
    ptrs = (a.data_ptr(), b.data_ptr())
    with state_kept([a, b]):
        a.mul_(3.0)
        b.zero_()
    assert torch.equal(a, torch.arange(4.0)) and torch.equal(b, torch.ones(2, 2))
    assert (a.data_ptr(), b.data_ptr()) == ptrs


def test_installs_keep_the_captured_tensors():
    """set_ckpt_state and set_optim_state copy into the tensors a graph
    would read (the same objects, the new values), and a checkpoint
    that fails validation changes nothing; forward_backward_multi on the
    CPU runs the steps in sequence."""
    from rpo_tpu_torch.methods.rpo_trainer import RPO
    from rpo_tpu_torch.models.clip.model import ARCHS, init_clip

    clip = init_clip(torch.Generator().manual_seed(0), ARCHS["TINY"])
    rpo = RPO(["a", "b", "c"], K=K, backbone="TINY", prec="fp32", device="cpu",
              clip_params=clip)
    before = list(rpo._graph_bound())
    state = {k: np.full(tuple(v.shape), 0.25, np.float32) for k, v in rpo.params.items()}
    rpo.set_ckpt_state(rpo.model_name, state)
    rpo.set_optim_state(rpo.model_name, state)
    assert all(a is b for a, b in zip(rpo._graph_bound(), before))
    assert all(float((t - 0.25).abs().max()) == 0 for t in rpo.params.values())
    assert float(rpo._optimizer.grad_weight) == 1.0  # dampening 0: 1 - 0
    bad = dict(state, img_prompt=np.zeros((K + 1, 64), np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        rpo.set_ckpt_state(rpo.model_name, bad)
    assert all(float((t - 0.25).abs().max()) == 0 for t in rpo.params.values())
    rng = np.random.RandomState(0)
    batches = [{"img": rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
                "label": np.array([0, 2]), "mask": np.ones(2, np.float32)} for _ in range(2)]
    rpo.current_lr = 0.01
    grouped = [float(s["loss"]) for s in rpo.forward_backward_multi(batches)]
    rpo.set_ckpt_state(rpo.model_name, state)
    rpo.set_optim_state(rpo.model_name, state)
    assert grouped == [float(rpo.forward_backward(b)["loss"]) for b in batches]


# -- on the card ------------------------------------------------------------------

def _gpu_rpo(**kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.methods.rpo_trainer import RPO

    torch.backends.cuda.matmul.allow_tf32 = False
    return RPO([f"object category {i}" for i in range(6)], K=4, backbone="TINY_W128",
               prec="fp16", seed=1, **kw)


def _gpu_batches(n, device_resize=0):
    rng = np.random.RandomState(7)
    side = device_resize or 32
    out = []
    for _ in range(n):
        b = {"img": rng.randint(0, 256, (4, side, side, 3)).astype(np.uint8),
             "label": rng.randint(0, 6, 4), "mask": np.array([1, 1, 1, 0], np.float32)}
        if device_resize:
            b["box"] = np.array([[0, 0, side, side], [2, 3, 20, 18], [5, 1, 30, 31],
                                 [0, 0, side, side]], np.int32)
            b["flip"] = np.array([0, 1, 1, 0], np.int32)
        out.append(b)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("device_resize", [0, 40], ids=["uint8 batches", "DEVICE_RESIZE 40"])
def test_graph_replays_equal_eager_steps_on_gpu(device_resize):
    """Ten eager steps, ten replays of the one-step graph and two replays
    of the five-step graph, each from the same state: the same losses
    and prompts (torch.equal), the rect kernel recorded two launches a
    vision layer a captured step and run as often in a profiled replay,
    the state after capture untouched."""
    from rpo_tpu_torch.ops import rect_attention as ra

    rpo = _gpu_rpo(device_resize=device_resize)
    batches = _gpu_batches(10, device_resize)
    first = {k: t.clone() for k, t in rpo.params.items()}
    eager = [rpo.train_step(rpo._train_images(b), b["label"], b["mask"], 0.01)[0]
             for b in batches]
    eager_prompts = {k: t.clone() for k, t in rpo.params.items()}
    rpo.current_lr = 0.01
    for n in (1, 5):
        rpo.set_ckpt_state(rpo.model_name, first)
        if n == 1:
            losses = [rpo.forward_backward(b)["loss"] for b in batches]
        else:
            losses = [s["loss"] for i in (0, 5) for s in rpo.forward_backward_multi(
                batches[i:i + 5])]
        torch.cuda.synchronize()
        assert torch.equal(torch.stack(losses), torch.stack(eager)), n
        for key, t in rpo.params.items():
            assert torch.equal(t, eager_prompts[key]), (n, key)
        graph = next(g for (steps, *_), g in rpo._graphs.items() if steps == n)
        assert graph.launches_per_replay["rect_attention.launches"] == (
            2 * rpo.clip_cfg.vision_layers * n)
        assert graph.replays == 10 // n
    # a replay calls no wrapper; the profiler sees the captured kernels run
    from torch.profiler import ProfilerActivity, profile

    rect0 = ra.launches
    rpo.set_ckpt_state(rpo.model_name, first)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rpo.forward_backward(batches[0])
        torch.cuda.synchronize()
    ran = sum(e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "attention_kernel" in e.key.lower() and "true" not in e.key.lower())
    assert ra.launches == rect0
    assert ran == 2 * rpo.clip_cfg.vision_layers


@pytest.mark.gpu
def test_resume_with_the_graph_on_gpu(tmp_path, monkeypatch):
    """A run stopped after epoch 1 and relaunched resumes from
    model.pth.tar-1 and captures its graphs after the resume
    (PREWARM_COMPILE): its epoch-2 steps, grouped and single, equal the
    eager steps from that checkpoint on the same batches (losses and
    prompts).  A trainable tensor replaced after the capture makes a
    replay raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rpo_tpu_torch.engine import build_trainer
    from rpo_tpu_torch.engine import trainer as engine_trainer

    out = str(tmp_path / "resumed")
    argv = run_args(out, prec="fp16", group=2) + [
        "MODEL.BACKBONE.NAME", "TINY_W128", "TRAIN.CHECKPOINT_FREQ", "1", "TEST.NO_TEST", "True"]
    run_epoch = engine_trainer.TrainerBase.run_epoch

    class Stopped(Exception):
        pass

    def stop_at_epoch_2(self):
        if self.epoch == 1:
            raise Stopped("stopped after epoch 1")
        run_epoch(self)

    monkeypatch.setattr(engine_trainer.TrainerBase, "run_epoch", stop_at_epoch_2)
    with pytest.raises(Stopped):
        run(tcli, PortTrainer, argv, monkeypatch)
    monkeypatch.setattr(engine_trainer.TrainerBase, "run_epoch", run_epoch)
    seen = []
    single, multi = PortTrainer.forward_backward, PortTrainer.forward_backward_multi

    def host(batch):
        return {k: batch[k].cpu().numpy() if isinstance(batch[k], torch.Tensor)
                else np.asarray(batch[k]) for k in ("img", "label", "mask")}

    monkeypatch.setattr(PortTrainer, "forward_backward",
                        lambda self, b: seen.append(host(b)) or single(self, b))
    monkeypatch.setattr(PortTrainer, "forward_backward_multi",
                        lambda self, bs: seen.extend(host(b) for b in bs) or multi(self, bs))
    losses, log, resumed = run(tcli, PortTrainer, argv, monkeypatch)
    assert "Resumed prompt_learner" in log and "Captured the train step" in log
    assert len(seen) == len(losses) == 5 and {n for n, *_ in resumed._graphs} == {1, 2}
    twin = build_trainer(resumed.cfg.clone(), device=resumed.device)
    ckpt = saved(out, epoch=1)
    twin.set_ckpt_state(twin.model_name, ckpt["state_dict"])
    twin.set_optim_state(twin.model_name, ckpt["optimizer"])
    lr = optim.lr_at_epoch(twin.cfg.OPTIM, 1)
    eager = [float(twin.train_step(b["img"], b["label"], b["mask"], lr)[0]) for b in seen]
    assert eager == losses
    for key, t in resumed.params.items():
        assert torch.equal(t, twin.params[key]), key
    resumed.params["img_prompt"] = resumed.params["img_prompt"].clone()
    resumed.current_lr = lr
    with pytest.raises(RuntimeError, match="replaced after"):
        resumed.forward_backward(seen[0])
