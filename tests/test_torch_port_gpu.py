"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each skips without a CUDA card.  This file imports no JAX
(the machine with the card has none), so it runs there without the JAX
package's conftest:

    python -m pytest --noconftest -q tests/test_torch_port_gpu.py
"""
import pytest
import torch

from rpo_tpu_torch.ops import rect_attention as ra


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,dtype,tol",
    [
        ((100, 12, 221, 197, 64), torch.bfloat16, 2e-2),
        ((3, 2, 9, 5, 32), torch.float32, 1e-5),
        ((2, 12, 221, 197, 64), torch.float32, 1e-5),
        ((2, 4, 221, 197, 128), torch.bfloat16, 2e-2),
        ((2, 3, 70, 130, 32), torch.bfloat16, 2e-2),
        ((2, 2, 33, 300, 64), torch.bfloat16, 2e-2),  # Lk > 256: two score passes
    ],
)
def test_kernel_matches_plain_version_on_gpu(shape, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, Lq, Lk, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (
        torch.randn(B, H, n, D, generator=gen, device="cuda").to(dtype) for n in (Lq, Lk, Lk)
    )
    before = ra.launches
    got = ra.rect_attention(q, k, v)
    torch.cuda.synchronize()
    assert ra.launches == before + 1
    err = (got.float() - ra.rect_attention_reference(q, k, v).float()).abs().max().item()
    assert err <= tol


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(1, 1, 8, 128, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        ra.rect_attention(q, torch.zeros(1, 1, 197, 128, device="cuda"),
                          torch.zeros(1, 1, 197, 128, device="cuda"))
    with pytest.raises(ValueError, match="head dim"):
        ra.rect_attention(*(torch.zeros(1, 1, 8, 48, device="cuda"),) * 3)
    with pytest.raises(TypeError):
        ra.rect_attention(*(torch.zeros(1, 1, 8, 64, device="cuda", dtype=torch.float16),) * 3)


@pytest.mark.gpu
def test_backward_through_the_kernel_on_gpu():
    """The kernel's forward under autograd, with the plain recompute as
    its backward, against autograd through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    base = [torch.randn(2, 3, n, 64, generator=gen, device="cuda") for n in (21, 17, 17)]
    cot = torch.randn(2, 3, 21, 64, generator=gen, device="cuda")
    grads = []
    for fn in (ra.rect_attention, ra.rect_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in base]
        (fn(*leaves) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
