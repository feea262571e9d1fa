"""The port's multi-rank paths on the card (``chip_smoke.py`` phase 17's
(a)-(c) at TINY).

Marked ``gpu``; each skips without a CUDA card.  No JAX here (the card's
machine has none), so it runs there without the JAX package's conftest:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_multi_rank_gpu.py

- (a) a one-rank NCCL group in this process: the dp step eagerly and as
  a one-step graph replay (its all-reduce captured) against the
  single-process step, the replay equal to the eager step;
- (b), (c) two gloo ranks sharing the card (``tools/dryrun_multichip.py``'s
  harness): a dp 2 train step and eval, and a tp 2 eval and train step,
  against one process, at the tool's bounds;
- tp's row-parallel partial product (tensor-core operands, a float32
  result) and its gradients against the float32 product on the CPU.
"""
import numpy as np
import pytest
import torch

from rpo_tpu_torch.tools import dryrun_multichip as dm

LR = 0.01


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _spec(arch="TINY", **kwargs):
    from rpo_tpu_torch.models.clip.model import ARCHS, init_clip

    return {"method": "RPO", "arch": arch, "prec": "fp16", "kwargs": kwargs,
            "clip": dm._np(init_clip(torch.Generator().manual_seed(0), ARCHS[arch]))}


def _batch(B, n_pad=1):
    return dm._batch(np.random.RandomState(B), B, 32, n_pad)


@pytest.mark.gpu
def test_nccl_one_rank_step_eager_and_captured_equal_one_process(tmp_path):
    """(a): the mesh is NCCL's, the steps are graphs; the replay equals
    the eager dp step, and both the single-process step (bf16 1e-2)."""
    _needs_card()
    import torch.distributed as dist

    spec = _spec()
    images, labels, mask = _batch(4)
    single = dm.execute(dm.build(spec, "cuda"), [("step", images, labels, mask, LR)])[0]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        trainer = dm.build(spec, "cuda")
        assert trainer.mesh.backend == "nccl" and not trainer._eager_steps
        first = dm._np(trainer.params)
        eager = dm.execute(trainer, [("step", images, labels, mask, LR)])[0]
        trainer.set_ckpt_state(trainer.model_name, first)
        trainer.current_lr = LR
        loss = trainer.forward_backward({"img": images, "label": labels, "mask": mask})["loss"]
        assert len(trainer._graphs) == 1
        assert float(loss) == eager["loss"]
        for key, value in dm._np(trainer.params).items():
            assert np.array_equal(value, eager["params"][key]), key
    finally:
        dist.destroy_process_group()
    assert not dm._compare("nccl", [eager], [single], "fp16")


@pytest.mark.gpu
@pytest.mark.parametrize("name,spec_kwargs,arch", [("dp", {}, "TINY"),
                                                   ("tp", {"tensor_parallel": 2}, "TINY_W128")])
def test_two_gloo_ranks_on_the_card_equal_one_process(tmp_path, name, spec_kwargs, arch):
    """(b) dp 2 and (c) tp 2, two ranks sharing the card: the eval
    logits (gathered) and a train step against one process."""
    _needs_card()
    spec = _spec(arch, **spec_kwargs)
    images, labels, mask = _batch(4)
    ops = [("eval", images), ("step", images, labels, mask, LR)]
    ranked = dm.run_jobs(2, [(name, spec, ops)], str(tmp_path), "cuda")[name]
    single = dm.execute(dm.build({**spec, "kwargs": {}}, "cuda"), ops)
    for r, got in enumerate(ranked):
        faults = dm._compare(f"{name} rank {r}", got, single, "fp16")
        assert not faults, faults


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_row_parallel_partial_product_on_the_card_equals_the_float32_product(dtype):
    """tp's row-parallel partial product on the card (low-precision
    operands on the tensor cores, a float32 result) and its gradients
    against the float32 product of the same operands on the CPU, after
    ``row_parallel``'s cast: within one rounding of ``dtype``."""
    _needs_card()
    from rpo_tpu_torch.parallel.tp import _PartialProduct

    gen = torch.Generator().manual_seed(0)
    h = (torch.randn(2, 197, 384, generator=gen) * 0.5).to(dtype)
    w = (torch.randn(384, 768, generator=gen) * 0.05).to(dtype)
    g = torch.randn(2, 197, 768, generator=gen).to(dtype)
    out = {}
    for device in ("cpu", "cuda"):
        hd, wd = (t.detach().to(device).requires_grad_(True) for t in (h, w))
        partial = _PartialProduct.apply(hd, wd, dtype)
        assert partial.dtype == torch.float32
        y = partial.to(dtype)
        y.backward(g.to(device))
        out[device] = [t.detach().float().cpu() for t in (y, hd.grad, wd.grad)]
    for name, got, want in zip(("product", "dh", "dw"), out["cuda"], out["cpu"]):
        err = (got - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item(), f"{name}: max err {err}"
