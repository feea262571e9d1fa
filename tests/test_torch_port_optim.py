"""The port's SGD and LR schedule against rpo_tpu.engine.optim.

The same gradients (numpy, from a seed) go through the JAX ``sgd_update``
and through the port's SGD as the port builds and steps it
(``engine.optim.SGD``, whose state is device tensors updated in place;
tests/test_torch_port_multi_step.py holds it to ``torch.optim.SGD`` too).
Tolerances: the schedule is the same float64 arithmetic (rtol 1e-9); an
SGD step is the same float32 operations, up to a fused multiply-add
(rtol 1e-6, atol 1e-7, as tests/test_optim_parity.py holds the JAX SGD
to torch's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpo_tpu.engine.optim import SGDState, lr_at_epoch as jax_lr_at_epoch, sgd_init, sgd_update
from rpo_tpu_torch.engine import optim

SGD_TOL = dict(rtol=1e-6, atol=1e-7)


@dataclasses.dataclass
class Optim:
    """The config's OPTIM names, as lr_at_epoch reads them."""
    LR: float = 0.01
    MAX_EPOCH: int = 15
    LR_SCHEDULER: str = "cosine"
    WARMUP_EPOCH: int = 1
    WARMUP_TYPE: str = "constant"
    WARMUP_CONS_LR: float = 1e-5
    WARMUP_MIN_LR: float = 1e-5
    STEPSIZE: tuple = (-1,)
    GAMMA: float = 0.1
    WARMUP_RECOUNT: bool = True


SCHEDULES = {
    "cosine, constant warmup (RPO main)": Optim(),
    "cosine, no warmup": Optim(WARMUP_EPOCH=-1),
    "constant": Optim(LR_SCHEDULER="constant", WARMUP_EPOCH=0),
    "cosine, linear warmup": Optim(WARMUP_EPOCH=3, WARMUP_TYPE="linear", WARMUP_MIN_LR=1e-4),
    "single_step": Optim(LR_SCHEDULER="single_step", STEPSIZE=(4,), WARMUP_EPOCH=-1),
    "single_step, no step size": Optim(LR_SCHEDULER="single_step", STEPSIZE=(-1,)),
    "multi_step, linear warmup": Optim(LR_SCHEDULER="multi_step", STEPSIZE=(3, 7, 11),
                                       WARMUP_EPOCH=2, WARMUP_TYPE="linear"),
    "cosine, WARMUP_RECOUNT False": Optim(WARMUP_EPOCH=2, WARMUP_RECOUNT=False),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_at_epoch_equals_jax(name):
    cfg = SCHEDULES[name]
    got = [optim.lr_at_epoch(cfg, e) for e in range(cfg.MAX_EPOCH)]
    want = [jax_lr_at_epoch(cfg, e) for e in range(cfg.MAX_EPOCH)]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert len(set(got)) > 1 or cfg.LR_SCHEDULER in ("constant", "single_step")


def test_lr_at_epoch_refuses_unknown_names():
    with pytest.raises(ValueError, match="LR_SCHEDULER"):
        optim.lr_at_epoch(Optim(LR_SCHEDULER="poly", WARMUP_EPOCH=0), 1)
    with pytest.raises(ValueError, match="WARMUP_TYPE"):
        optim.lr_at_epoch(Optim(WARMUP_TYPE="exp"), 0)


def _params(rng):
    """A trainable tree with a nested dict, as CoCoOp's meta_net."""
    return {"text_prompt": rng.randn(3, 8).astype(np.float32),
            "meta_net": {"w1": rng.randn(8, 2).astype(np.float32),
                         "b1": rng.randn(2).astype(np.float32)}}


def _torch_tree(tree):
    return optim.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _close(got, want, what):
    optim.tree_map(lambda g, w: np.testing.assert_allclose(g.numpy(), np.asarray(w), **SGD_TOL,
                                                           err_msg=what), got, want)


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


@pytest.mark.parametrize("name", list(SETTINGS))
def test_sgd_equals_sgd_update(name):
    """Six steps at changing LRs; params and momentum after each."""
    kw = SETTINGS[name]
    rng = np.random.RandomState(0)
    p0 = _params(rng)
    jp, state = jax.tree_util.tree_map(jnp.asarray, p0), sgd_init(p0)
    tp = _torch_tree(p0)
    opt = optim.sgd(tp, **kw)
    for step, lr in enumerate((0.01, 0.01, 0.005, 0.02, 1e-5, 0.01)):
        g = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), p0)
        jp, state = sgd_update(jp, jax.tree_util.tree_map(jnp.asarray, g), state, lr, **kw)
        optim.sgd_step(opt, tp, _torch_tree(g), lr)
        _close(tp, jp, f"params after step {step}")
        if kw["momentum"]:
            _close(optim.sgd_momentum(opt, tp), state.momentum, f"momentum after step {step}")
        assert all(p.grad is None for p in optim.tree_leaves(tp))


@pytest.mark.parametrize("name", ["plain (RPO main)", "dampening, first-buffer rule", "nesterov"])
def test_state_carried_from_jax_gives_the_same_next_step(name):
    """A mid-run JAX SGDState (step 3) installed in a fresh optimizer,
    then one more step on both; and step 0 installs no buffer, so the
    next update is the first-buffer one."""
    kw = SETTINGS[name]
    rng = np.random.RandomState(1)
    p0 = _params(rng)
    grads = [jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), p0)
             for _ in range(4)]
    jp, state = jax.tree_util.tree_map(jnp.asarray, p0), sgd_init(p0)
    for g in grads[:3]:
        jp, state = sgd_update(jp, g, state, 0.01, **kw)
    assert int(state.step) == 3
    tp = _torch_tree(jax.tree_util.tree_map(np.asarray, jp))
    opt = optim.sgd(tp, **kw)
    optim.sgd_state_from_numpy(opt, tp, jax.tree_util.tree_map(np.asarray, state.momentum),
                               int(state.step))
    jp, state = sgd_update(jp, grads[3], state, 0.01, **kw)
    optim.sgd_step(opt, tp, _torch_tree(grads[3]), 0.01)
    _close(tp, jp, "params after the carried step")
    _close(optim.sgd_momentum(opt, tp), state.momentum, "momentum after the carried step")

    # step 0 installs no buffer: with dampening sgd_update's first write
    # ignores the momentum tree too; without, JAX's step-0 tree is
    # sgd_init's zeros
    stale = jax.tree_util.tree_map(lambda a: np.full(a.shape, 7.0, np.float32), p0)
    jp0, jstate0 = sgd_update(jax.tree_util.tree_map(jnp.asarray, p0), grads[0],
                              SGDState(momentum=stale, step=jnp.zeros((), jnp.int32)), 0.01, **kw)
    tp0 = _torch_tree(p0)
    opt0 = optim.sgd(tp0, **kw)
    optim.sgd_state_from_numpy(opt0, tp0, stale, 0)
    optim.sgd_step(opt0, tp0, _torch_tree(grads[0]), 0.01)
    if kw["dampening"]:
        _close(tp0, jp0, "params after a step-0 install")
        _close(optim.sgd_momentum(opt0, tp0), jstate0.momentum, "momentum after step 0")
    else:
        _close(tp0, sgd_update(jax.tree_util.tree_map(jnp.asarray, p0), grads[0], sgd_init(p0),
                               0.01, **kw)[0], "params after a step-0 install")


def test_state_install_checks_shapes_and_nesterov_with_dampening_raises():
    tp = _torch_tree(_params(np.random.RandomState(2)))
    opt = optim.sgd(tp)
    bad = optim.tree_map(lambda t: np.zeros(t.shape[:-1] + (t.shape[-1] + 1,)), tp)
    with pytest.raises(ValueError, match="momentum of shape"):
        optim.sgd_state_from_numpy(opt, tp, bad, 1)
    with pytest.raises(ValueError, match="zero dampening"):
        optim.sgd(tp, nesterov=True, dampening=0.1)
