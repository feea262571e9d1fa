"""The yardstick's counts against the figures worked out by hand."""
from __future__ import annotations

import pytest

from benchmark import yardstick as Y
from benchmark.methods import cocoop, rpo

H100 = Y.peaks("NVIDIA H100 80GB HBM3")


def test_peaks_by_card_name():
    assert H100 == (3.35e12, 989e12)
    assert Y.peaks("NVIDIA H100 PCIe") == (2.0e12, 756e12)
    assert Y.peaks("some other card") == H100


def test_rect_attention_call_at_rpo_eval():
    n_bytes, n_flops = Y.rect_attention_work(100, 12, 221, 197, 64)
    assert round(n_bytes / 1e6, 1) == 128.4
    ms, by = Y.bound(n_bytes, n_flops, *H100)
    assert (round(ms, 4), by) == (0.0383, "bytes")


def test_fused_text_layer_call_at_cocoop_eval():
    n_bytes, n_flops = Y.fused_text_layer_work(510, 16, 512, 8)
    assert round(n_flops / 1e9, 2) == 51.61
    assert round(n_bytes / 1e6, 2) == 23.02
    ms, by = Y.bound(n_bytes, n_flops, *H100)
    assert (round(ms, 4), by) == (0.0522, "operations")


TINY = {"embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
        "vision_heads": 1, "vision_patch_size": 16, "text_width": 64, "text_heads": 2,
        "text_layers": 2, "context_length": 77}


def mm(m, k, n):
    """A product of (m, k) by (k, n): 2 m k n operations."""
    return 2 * m * k * n


def hand_layer(d, q_rows, kv_rows, pairs):
    """q, out, fc, proj on the query rows; k and v on the key rows; QK^T
    and PV, each a product of (Lq, d) by (d, Lk) summed over sequences."""
    return (mm(q_rows, d, d) + mm(q_rows, d, d) + mm(q_rows, d, 4 * d) + mm(q_rows, 4 * d, d)
            + 2 * mm(kv_rows, d, d) + 2 * 2 * d * pairs)


def test_rpo_train_step_flops_at_tiny():
    # 2 images of 32 px: 4 patches of 16 x 16 x 3 and the class row, S = 5;
    # K = 3 prompts; 2 classes whose prompts hold 6 and 8 real tokens
    B, K, S, d, E, lens = 2, 3, 5, 64, 64, [6, 8]
    patch = mm(B * 4, 768, d)
    frozen = patch + 2 * hand_layer(d, B * S, B * S, B * S * S)
    vision_prompts = 2 * hand_layer(d, B * K, 0, B * K * S) + mm(B * K, d, E)
    text_prompts = 2 * hand_layer(d, 2 * K, 0, K * 6 + K * 8) + mm(2 * K, d, E)
    logits = mm(B, K * E, 2)
    want = frozen + 2 * (vision_prompts + text_prompts + logits)
    assert Y.rpo_train_step_flops(TINY, K, lens, B) == pytest.approx(want, rel=1e-12)


def test_rpo_eval_batch_flops_at_tiny():
    B, K, S, d, E, n_cls = 3, 2, 5, 64, 64, 7
    want = (mm(B * 4, 768, d) + 2 * hand_layer(d, B * (S + K), B * S, B * (S + K) * S)
            + mm(B * K, d, E) + mm(B, K * E, n_cls))
    assert Y.rpo_eval_batch_flops(TINY, K, n_cls, B) == pytest.approx(want, rel=1e-12)


def test_cocoop_eval_batch_flops_at_tiny():
    B, S, d, E, rows = 2, 5, 64, 64, [9, 11, 10]
    vision = mm(B * 4, 768, d) + 2 * hand_layer(d, B * S, B * S, B * S * S) + mm(B, d, E)
    meta = mm(B, E, E // 16) + mm(B, E // 16, d)
    text = B * (2 * hand_layer(d, sum(rows), sum(rows), sum(r * r for r in rows))
                + mm(len(rows), d, E))
    want = vision + meta + text + mm(B, E, len(rows))
    assert Y.cocoop_eval_batch_flops(TINY, rows, B, 4) == pytest.approx(want, rel=1e-12)


def test_work_lists_the_kernel_calls_of_a_step():
    config = {"clip": dict(TINY, image_resolution=224, vision_layers=12, vision_width=768,
                           vision_heads=12, text_width=512, text_heads=8, text_layers=12,
                           embed_dim=512), "K": 24, "prompt_template": "a photo of a _.",
              "n_ctx": 4, "ctx_init": "a photo of a", "eval_chunk": 10}
    names = ["red fox", "oak", "great crested newt"] * 17
    train = rpo.work(config, {"kind": "train", "batch": 4}, names)
    calls = train.kernels["rect_attention kernel"]
    assert len(calls) == 24
    assert calls[0] == Y.rect_attention_work(4, 12, 197, 197, 64)
    assert calls[12] == Y.rect_attention_work(4, 12, 24, 197, 64)
    ev = rpo.work(config, {"kind": "eval", "batch": 100}, names)
    assert ev.kernels["rect_attention kernel"] == [Y.rect_attention_work(100, 12, 221, 197, 64)] * 12
    co = cocoop.work(config, {"kind": "eval", "batch": 100}, names)
    assert co.kernels["fused_text_layer kernel"] == [Y.fused_text_layer_work(510, 16, 512, 8)] * 120
    assert co.kernels["rect_attention kernel"] == [Y.rect_attention_work(100, 12, 197, 197, 64)] * 12


@pytest.mark.parametrize("name,group", [
    ("void attention_kernel_tc<64, false, 13>(attention_tc::Params, int, long long, int)",
     "rect_attention kernel"),
    ("void attention_kernel_tc<64, true, 13>(attention_tc::Params, int, long long, int)",
     "masked_attention kernel"),
    ("fused_text_layer_kernel(Params)", "fused_text_layer kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("Memcpy HtoD (Pinned -> Device)", "copy/cast"),
])
def test_kernel_groups(name, group):
    assert Y.kernel_group(name) == group
