#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (rpo_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device   card name, nvidia-smi name and power limit, TF32 off;
  2. build    every CUDA source under rpo_tpu_torch/ops/csrc with nvcc;
  3. kernels  each kernel against its plain PyTorch version on the card
              at the main path's shapes, with its time, the plain
              version's, one PyTorch library call's and the card's bound;
  4. slice    RPO evaluation of ViT-B/16 in bf16 (K=24, 51 classes) on
              three batches of 100 seeded uint8 images, through the
              trainer's entry points; launches counted; logits checked
              against the same batches on the plain attention; one more
              batch under torch.profiler for where the time goes.
Then a JSON line of the kernels, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.  Imports nothing of JAX or rpo_tpu.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Bytes/s and dense bf16 FLOP/s by card (NVIDIA data sheets); the first
# name fragment that matches wins, the H100 SXM (last) is the default.
PEAKS = [
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100 NVL", 3.9e12, 835e12),
    ("H200", 4.8e12, 989e12),
    ("H100", 3.35e12, 989e12),
]
K = 24
N_CLS = 51
EVAL_BATCH = 100
N_BATCHES = 3
BF16_TOL = 2e-2  # inputs N(0, 1): about 2 bf16 ulps of outputs below 2
F32_TOL = 1e-5
# Slice logits, kernel vs plain attention in every layer: the two differ
# by bf16 rounding flips (summation order) that compound over 12 layers;
# logits are exp(logit_scale) = 14.3 x a cosine averaged over K pairs, so
# 5e-2 is a cosine difference of 0.0035.  Argmax may flip only where two
# classes' logits are that close.
SLICE_ATOL = 5e-2
SLICE_ARGMAX_AGREE = 0.98


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def time_ms(fn, n: int, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``n`` calls, CUDA events around each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def path_layout_qkv(gen, B, H, Lq, Lk, D, dtype):
    """q, k, v as the eval tower hands them to the kernel: head views of
    the projection outputs (B, L, H*D) and (B, Lk, 2*H*D)."""
    q = torch.randn(B, Lq, H * D, generator=gen, device="cuda").to(dtype)
    kv = torch.randn(B, Lk, 2 * H * D, generator=gen, device="cuda").to(dtype)
    q = q.view(B, Lq, H, D).permute(0, 2, 1, 3)
    kv = kv.view(B, Lk, 2 * H, D).permute(0, 2, 1, 3)
    return q, kv[:, :H], kv[:, H:]


def profile_eval_step(rpo, images, smi: str) -> None:
    """One more eval batch under torch.profiler: device time by kernel
    group and the device's idle share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    rpo.eval_step(images)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        rpo.eval_step(images)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    groups = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        n = evt.key.lower()
        group = ("rect_attention kernel" if "rect_attention" in n
                 else "matmul" if any(w in n for w in ("gemm", "cutlass", "xmma", "nvjet", "sm90"))
                 else "layer_norm" if "layer_norm" in n
                 else "softmax/reduce" if any(w in n for w in ("softmax", "reduce"))
                 else "copy/cast" if any(w in n for w in ("copy", "memcpy", "cat"))
                 else "elementwise" if "elementwise" in n
                 else "other")
        groups[group] = groups.get(group, 0.0) + us
    busy = sum(groups.values())
    if busy == 0:
        print("profile: the profiler saw no device time (not measured)")
        return
    parts = ", ".join(f"{g} {us / 1e3:.2f} ms ({us / busy:.1%})"
                      for g, us in sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"profile eval batch on {smi}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {max(0.0, 1 - busy / wall_us):.1%}; {parts}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rpo_tpu_torch.methods.rpo_trainer import RPO
    from rpo_tpu_torch.ops import _build
    from rpo_tpu_torch.ops import rect_attention as ra

    # ---- 1. device --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bw, peak = next(((b, p) for frag, b, p in PEAKS if frag in name), PEAKS[-1][1:])
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} | peaks {bw / 1e12} TB/s, "
          f"{peak / 1e12} TFLOP/s bf16", flush=True)

    # ---- 2. build ---------------------------------------------------------
    secs, logs = _build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {len(logs)} source(s) in {secs:.1f} s", flush=True)
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    # ---- 3. kernels against their plain versions --------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = [
        ("eval layer, path layout", (100, 12, 221, 197, 64), torch.bfloat16, BF16_TOL, False),
        ("eval layer, paired adapter", (100, 6, 221, 197, 128), torch.bfloat16, BF16_TOL, True),
        ("ragged tiny", (3, 2, 9, 5, 32), torch.float32, F32_TOL, False),
        ("TINY tower", (3, 1, 9, 5, 64), torch.bfloat16, BF16_TOL, False),
        ("eval layer f32", (2, 12, 221, 197, 64), torch.float32, F32_TOL, False),
        ("head dim 128", (2, 4, 221, 197, 128), torch.bfloat16, BF16_TOL, False),
        ("head dim 32", (2, 3, 70, 130, 32), torch.bfloat16, BF16_TOL, False),
        ("Lk over 256: two score passes", (2, 2, 33, 300, 64), torch.bfloat16, BF16_TOL, False),
    ]
    prod_err = None
    for label, (B, H, Lq, Lk, D), dtype, tol, paired in checks:
        if paired:
            q, k, v = (torch.randn(B, H, n, D, generator=gen, device="cuda").to(dtype)
                       for n in (Lq, Lk, Lk))
            out = ra.rect_attention_paired(q, k, v, D // 2)
            ref = ra.pair_heads(ra.rect_attention_reference(
                *(ra.unpair_heads(t, D // 2) for t in (q, k, v))))
        else:
            q, k, v = path_layout_qkv(gen, B, H, Lq, Lk, D, dtype)
            out = ra.rect_attention(q, k, v)
            ref = ra.rect_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = err <= tol and bool(torch.isfinite(out).all())
        print(f"kernel rect_attention {label} {(B, H, Lq, Lk, D)} {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"rect_attention {label}: max abs err {err} > {tol}")
        if prod_err is None:
            prod_err = err
    try:
        z = torch.zeros(1, 1, 197, 128, device="cuda")
        ra.rect_attention(z[:, :, :8], z, z)
        fail("rect_attention took f32 K/V that do not fit shared memory")
    except ValueError as exc:
        print(f"kernel rect_attention refuses f32 (1,1,8,197,128): {exc}")

    B, H, Lq, Lk, D = 100, 12, 221, 197, 64
    q, k, v = path_layout_qkv(gen, B, H, Lq, Lk, D, torch.bfloat16)
    ms = time_ms(lambda: ra.rect_attention(q, k, v), 30)
    plain_ms = time_ms(lambda: ra.rect_attention_reference(q, k, v), 10)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 30)
    n_bytes = 2 * B * H * (Lq + Lk + Lk + Lq) * D
    n_flops = 4 * B * H * Lq * Lk * D
    bytes_ms, flops_ms = n_bytes / bw * 1e3, n_flops / peak * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
    print(f"time rect_attention (100,12,221,197,64) bf16 on {smi}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"by {bound_by} ({n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.2f} GFLOP)", flush=True)

    # ---- 4. the slice: RPO ViT-B/16 bf16 eval through the trainer ----------
    classnames = [f"object category {i}" for i in range(N_CLS)]
    rng = np.random.RandomState(2)
    batches = [rng.randint(0, 256, (EVAL_BATCH, 224, 224, 3)).astype(np.uint8)
               for _ in range(N_BATCHES)]
    ra.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rpo = RPO(classnames, "a photo of a _.", K=K, backbone="ViT-B/16", prec="fp16", seed=1)
    rpo.text_features()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batch_s, logits = [], []
    for images in batches:
        t = time.perf_counter()
        out = rpo.eval_step(images)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t)
        logits.append(out)
    launches = ra.launches
    n_layers = rpo.clip_cfg.vision_layers
    for out in logits:
        if tuple(out.shape) != (EVAL_BATCH, N_CLS) or not bool(torch.isfinite(out).all()):
            fail(f"slice logits have shape {tuple(out.shape)} or are not finite")
    if launches != n_layers * N_BATCHES:
        fail(f"rect_attention launched {launches} times, expected {n_layers} x {N_BATCHES}")
    plain = [rpo.eval_step(images, rect_attn=ra.rect_attention_reference) for images in batches]
    mine, plain = torch.cat(logits), torch.cat(plain)
    diff = (mine - plain).abs().max().item()
    flips = int((mine.argmax(-1) != plain.argmax(-1)).sum())
    agree = 1.0 - flips / mine.shape[0]
    top2 = plain.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).median().item()
    ok = diff <= SLICE_ATOL and agree >= SLICE_ARGMAX_AGREE
    print(f"slice RPO ViT-B/16 bf16 K={K} n_cls={N_CLS}: logits {tuple(logits[0].shape)} x "
          f"{N_BATCHES} finite; launches {launches} = {n_layers} x {N_BATCHES}; vs plain attention "
          f"max_abs_err {diff:.3e} (tol {SLICE_ATOL}), argmax agree {agree:.4f} ({flips} of "
          f"{mine.shape[0]} flip; >= {SLICE_ARGMAX_AGREE}) {'ok' if ok else 'FAIL'}; logit range "
          f"[{mine.min().item():.3f}, {mine.max().item():.3f}], median top-2 margin {margin:.4f}",
          flush=True)
    if not ok:
        fail("slice logits disagree with the plain-attention run")
    med = statistics.median(batch_s)
    print(f"eval on {smi}: setup (weights, text K/V, text features) {setup_s:.2f} s; "
          f"batch seconds {[round(s, 4) for s in batch_s]}; {EVAL_BATCH / med:.1f} images/s "
          f"at the median batch, {EVAL_BATCH * N_BATCHES / sum(batch_s):.1f} over all "
          f"{N_BATCHES}", flush=True)
    profile_eval_step(rpo, batches[-1], smi)

    print(json.dumps({"kernels": [{
        "name": "rect_attention",
        "route": "cuda",
        "source": "rpo_tpu_torch/ops/csrc/rect_attention.cu",
        "replaces": "rpo_tpu/ops/pallas_attention.py:196",
        "also_replaces": "rpo_tpu/ops/pallas_attention.py:114",
        "launches": launches,
        "max_abs_err": prod_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
