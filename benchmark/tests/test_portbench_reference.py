"""The plain reference against the port at TINY on the CPU: an RPO train
step, RPO eval and CoCoOp eval, from the same weights and state.  The
port runs in float32 (PREC fp32), so the two agree to float32 rounding."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs
from benchmark.methods import cocoop, rpo
from benchmark.methods.common import port_clip
from benchmark.reference.precision import EXACT
from benchmark.reference.sgd import leaves, train_steps

from conftest import TINY_CLIP

NAMES = ["red fox", "oak", "great crested newt", "violin", "small dark owl"]


def setup(method, config, seed=7):
    config = dict(config, clip=TINY_CLIP, prec="fp32")
    sd = inputs.state_dict(TINY_CLIP, seed, "cpu", dtype=torch.float32)
    state = method.make_state(config, sd, seed + 1, "cpu")
    params, cfg = port_clip(config, sd, "cpu")
    trainer = method.build_trainer(config, NAMES, params, cfg, "cpu")
    trainer.set_ckpt_state(method.MODEL, state)
    ref = method.reference(config, sd, NAMES)
    images = torch.from_numpy(inputs.image_pool(3, 4, 32, seed + 2, "cpu"))
    return config, trainer, ref, state, images


def rpo_config():
    import json
    from conftest import REPO
    return json.loads((REPO / "benchmark/configs/rpo_vit_b16.json").read_text())


def cocoop_config():
    import json
    from conftest import REPO
    return json.loads((REPO / "benchmark/configs/cocoop_vit_b16.json").read_text())


def test_rpo_eval_logits_agree():
    _, trainer, ref, state, images = setup(rpo, rpo_config())
    with torch.no_grad():
        got = trainer.eval_step(images[0])
        want = ref.logits(state, images[0], EXACT)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


def test_cocoop_eval_logits_agree():
    _, trainer, ref, state, images = setup(cocoop, cocoop_config())
    with torch.no_grad():
        got = trainer.eval_step(images[0])
        want = ref.logits(state, images[0], EXACT)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


def test_rpo_train_steps_agree():
    config, trainer, ref, state, images = setup(rpo, rpo_config())
    labels = torch.from_numpy(inputs.labels_pool(3, 4, len(NAMES), 9))
    mask = torch.ones(4)
    lr = 0.01
    losses = []
    for i in range(3):
        loss, _ = trainer.train_step(images[i], labels[i], mask, lr)
        losses.append(float(loss))
    out = train_steps(lambda s, x: ref.logits(s, x, EXACT), state,
                      [(images[i], labels[i]) for i in range(3)], lr, config["momentum"],
                      config["weight_decay"])
    np.testing.assert_allclose(losses, out["losses"], rtol=0, atol=1e-5)
    got, start = leaves(trainer.params), leaves(state)
    for k in start:
        update, want = got[k] - start[k], out["params"][k] - start[k]
        assert float((update - want).norm() / want.norm()) < 1e-3, k


def test_port_in_bfloat16_is_near_the_reference():
    """The configuration's own precision: the logits within bfloat16's
    rounding of the reference's."""
    config = dict(rpo_config(), clip=TINY_CLIP)
    sd = inputs.state_dict(TINY_CLIP, 3, "cpu")
    state = rpo.make_state(config, sd, 4, "cpu")
    params, cfg = port_clip(config, sd, "cpu")
    trainer = rpo.build_trainer(config, NAMES, params, cfg, "cpu")
    trainer.set_ckpt_state(rpo.MODEL, state)
    ref = rpo.reference(config, inputs.as_float32(sd, "cpu"), NAMES)
    images = torch.from_numpy(inputs.image_pool(1, 4, 32, 5, "cpu"))[0]
    with torch.no_grad():
        gap = (trainer.eval_step(images) - ref.logits(state, images, EXACT)).abs().max()
    assert 0 < float(gap) < 0.1
