#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (rpo_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device   card name, nvidia-smi name and power limit; TF32 and
              cuBLAS's reduced-precision bf16 reduction as the package's
              ``device.resolve_device`` leaves them (off, else it fails);
  2. build    every CUDA source under rpo_tpu_torch/ops/csrc with nvcc;
  3. kernels  the package's kernel selftest (rpo_tpu_torch/ops/selftest.py,
              run_selftest; one line a check, any failed check fails the
              phase): each kernel against its plain PyTorch version on the
              card at the main paths' shapes and at the bf16 attention
              kernel's edges, the attention kernels' mean error against an
              f64 evaluation of their contract (at most 1.1x their plain
              versions'), the rect kernel at the RPO train step's two
              shapes and the baselines' frozen image tower (batch 32 and
              1), the masked kernel under grad ((10 | 80, 8, 16, 16, 64):
              dq, dk, dv against autograd through the plain version), the
              fused layers element by element and in the mean with their
              planted-fault controls, the wrappers' refusals, the paired
              rect backward, a whole rect residual block and the device
              preprocess against the host's resample; then, on inputs of
              their own, the kernels' times (the median of calls each
              synchronised, launch included), the plain version's, one
              PyTorch library call's and the card's bound (for the fused
              rect halves, the unfused port path's time instead of a
              library call's, and each half's launch plan and device time
              split by kernel; the masked kernel at L = 77, 24 and 16);
              for the attention kernels and SDPA also back-to-back calls
              and the device time alone (torch.profiler), and the plain
              backward's time under grad;
  4. RPO      RPO evaluation of ViT-B/16 in bf16 (K=24, 51 classes) on
              three batches of 100 seeded uint8 images, through the
              trainer's entry points; launches counted (12 masked in the
              set-up's text K/V, 12 rect per batch); logits checked
              against the same batches fully on the plain versions (a
              text K/V cache built with the plain masked attention, the
              plain rect attention in the tower); one more batch under
              torch.profiler for where the time goes;
  5. CoOp     CoOp evaluation (N_CTX 16, end, no CSC) on the same
              backbone and batches: 12 masked launches for the text
              features, 12 rect per batch; logits against the plain run;
  6. zero-shot  ZeroshotCLIP (Caltech101's template) as in phase 5, and
              ZeroshotCLIP2's 8-template text features (96 masked
              launches) against their plain version;
  7. CoCoOp   CoCoOp evaluation (N_CTX 4, no CTX_INIT) on the same
              backbone and batches: 12 rect launches per batch for the
              image tower, then per chunk of 10 images one (510, 16, 512)
              batch of text towers whose every layer is one launch of the
              whole-layer kernel (120 per batch), no masked launch; logits
              against the same path on both plain versions, on the text
              side's and on the vision side's, and each run against an
              f32 witness; the checks again on a second random draw;
  8. flag     CoOp eval images/s with cuBLAS's reduced-precision bf16
              reduction off and on, in turns;
  9. RPO fused  RPO evaluation as in phase 4, with every vision layer one
              fused attention-half call and one fused MLP-half call (36
              each for three batches, no rect launch, 12 masked in
              set-up); logits against the same path on the plain halves
              and against phase 4's logits; a profile, whose batch must
              show 4 CUDA launches a call of the attention half (LN1,
              q/k/v, attention, out) and 3 of the MLP half (LN2, fc,
              proj), as their launch plans say;
 10. RPO train  RPO training of ViT-B/16 in bf16 (K=24, 51 classes, batch
              4, float32 prompts, LR 0.01) through the trainer's train
              step: 12 masked launches in the set-up, 24 rect launches a
              step (12 on the frozen rows, 12 on the prompt rows), no
              fused one; the first step's loss, logits and prompt
              gradients, and ten steps' losses, against the same steps
              fully on the plain versions; train images/s at the median
              of 20 synchronised steps after warm-up; one step profiled;
              then the step as a CUDA graph through the engine's hooks:
              ten replays of the one-step graph and two of the five-step
              graph from the same first prompts, against the ten eager
              steps (losses and prompts torch.equal, else within the
              train bound, the gap printed), the rect launches the
              wrappers count (each graph's warm-up step and capture, 24 a
              step; a replay calls no wrapper), train images/s at the
              median of 20 replays of each, and a profiled replay of each
              whose rect kernels on the device must be 24 a step;
 11. RPO run  the program a user runs: ``rpo_tpu_torch.cli.main`` (in
              this process, for the counters) trains configs/trainers/
              RPO/main_K24.yaml on configs/datasets/synthetic.yaml, 16
              shots of 10 classes (40 steps an epoch at batch 4), seed 1,
              two epochs, on its own seed-1 ViT-B/16 in bf16, through the
              engine's data path, epoch loop (each step one replay of the
              one-step graph, captured before the first batch:
              TRAIN.PREWARM_COMPILE), checkpoint and final test: losses
              finite, the log contract, model.pth.tar-2; rect launches 24
              a step of its graph's warm-up and capture, 12 an eval batch,
              masked 12 for the one text set-up, the capture's 24 a step
              times the replays covering the 80 steps, and a profiled
              replay on a third epoch's batches running 24 rect kernels a
              step on the device; an eval-only run of the
              checkpoint prints the same accuracy; the last test batch's
              logits against both plain versions (phase 4's bounds) and
              epoch 1's losses against the same epoch on them, eagerly
              (phase 10's bound); the engine's step and data time, and
              its train images/s over epoch 2 beside phase 10's;
 12. RPO run, one dispatch  phase 11's run with TRAIN.STEPS_PER_DISPATCH
              4 (ten replays of the four-step graph an epoch): the
              launches and the log contract, epoch 1's 40 losses against
              phase 11's on the same batches; then the same with
              INPUT.DEVICE_RESIZE 224 (the sources, crop boxes and flips
              go to the device, where the captured step resamples them):
              the log contract, finite losses, the card's crops of the
              loader's sources, boxes and flips against the same function
              on the CPU and against the host's resample in uint8 steps
              (two planted faults must fail), the eval-only accuracy and
              the checkpoint's logits against both plain versions; each
              run's train images/s over epoch 2 and its step and data
              means beside phase 11's.
 13. baselines  every ViT-B/16 baseline of the paper through the CLI on
              Synthetic, two epochs, seed 1, the port's own seed-1
              backbone in bf16, as phase 11: CoOp (vit_b16_ep50_ctxv1,
              batch 32, 16 shots), CoCoOp (vit_b16_c4_ep10_batch1, batch
              1, 4 shots; then at batch 16, the exact gradient
              accumulation over chunks of 8), LP (vit_b16_c4_ep10_batch1,
              batch 1, 4 shots); each run's launches (a CoOp step 12 rect
              and 12 masked, a CoCoOp step 12 rect and 12 masked a text
              tower, an LP step 12 rect; a CoCoOp eval batch 120 fused
              text-layer launches), the log contract, the checkpoint, a
              profiled replay's kernels, a replay against the eager step
              from the same state, the attention backward's share of a
              profiled eager step, an eval-only reload at the same
              accuracy, the last test batch's logits against both plain
              versions (CoCoOp with phase 7's f32 witness), epoch 1
              against the same epoch eagerly on both plain versions, and
              at CoCoOp batch 16 the accumulated first step against the
              monolithic one; then ZeroshotCLIP and ZeroshotCLIP2
              --eval-only on the new classes (12 and 96 masked launches);
              each run's train images/s over epoch 2.
 14. ResNet  the ModifiedResNet towers: ZeroshotCLIP in process on a
              random seed-1 RN50 and RN101 (three batches of 100 at 224)
              and RN50x4 and RN50x16 (one batch at 288 and 384), in bf16
              after a warm-up batch: 12 masked launches for the text
              set-up, no rect one; logits against the plain masked
              attention (5e-2, argmax 97%), each image's features against
              an f32 witness (cosine >= 0.99), images/s, a profile of RN50
              and RN101 (cuDNN convs, BN, pooling, the attention pool in a
              labelled range); CoOp's rn50_ep50 through the CLI as phase
              13's CoOp run (batch 32, 16 shots: 12 masked and no rect
              kernel a step, the replay against the eager step, the
              eval-only reload, epoch 1 against the plain versions, engine
              images/s); ZeroshotCLIP --eval-only on RN101 (rn101.yaml) and
              ZeroshotCLIP2 on an RN50 loaded through $CLIP_CHECKPOINT from
              a random OpenAI-layout fp16 state dict the script writes,
              whose tree must equal convert_state_dict's of that dict.
 15. file datasets  (a) one line: whether Pillow imports, whether g++ is
              there, whether the port's native JPEG library builds and
              loads, and so which decoder serves; (b) the fifteen
              file-backed readers on trees in their on-disk layouts
              (rpo_tpu_torch/tools/fake_datasets.py, image files copied
              from tests/torch_port_data), under NUM_SHOTS -1 and 16 and
              SUBSAMPLE_CLASSES all, base and new: train_x, val, test and
              the classnames against what the tree defines, the few-shot
              cache, a second build equal (pure Python, whatever (a)
              found); (c) with a decoder, the CLI: RPO main_K24 on a
              Caltech101 tree of 10 classes x 40 JPEGs of mixed sizes (16
              shots of the base classes, two epochs at batch 4, the test
              split) checked as phase 11 (launches, log contract, losses,
              an eval-only reload's logits against both plain versions),
              again with INPUT.DEVICE_RESIZE 224 on a tree of the 224 x
              224 fixtures (the device augmentation as in phase 12), and
              ZeroshotCLIP2 --eval-only on an ImageNet tree (10 wnids, 100
              val images; classnames.txt, preprocessed.pkl, 7 templates:
              84 masked launches); each run's engine means and images/s
              beside phase 11's and the batches the native library made.
              Without a decoder (c) prints one line saying what is missing
              and which CPU test holds that path.
 16. tools   the package's tools: ``python -m
              rpo_tpu_torch.tools.kernel_selftest`` as a subprocess (exit
              0, as many checks as phase 3, all passing);
              ``tools/profile_step.py`` for train (graph replays) and eval,
              5 steps each (device time by group, idle share); phase 11's
              checkpoint through ``tools/export_torch_ckpt.py`` and back;
              ``tools/bench_device_preprocess.py`` for eval and train at a
              few iterations.
Then a JSON line of the kernels, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.  The ViT-B/16 backbone is drawn once
from seed 1 and shared by the methods of phases 4-10.  Imports nothing
of JAX or rpo_tpu.
"""
from __future__ import annotations

import contextlib
import glob
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

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
N_CTX = 16
BASELINE_TRAIN_BATCH = 32  # configs/trainers/CoOp/vit_b16_ep50_ctxv1.yaml's
N_CLS = 51
EVAL_BATCH = 100
N_BATCHES = 3
TRAIN_BATCH = 4  # the main_K24 protocol's train batch
TRAIN_LR = 0.01  # configs/trainers/RPO/main.yaml's LR, its first epoch after warmup
N_TRAIN_CHECK = 10  # steps whose losses are held against the plain run
TRAIN_WARMUP = 3
N_TRAIN_TIMED = 20
GRAPH_GROUP = 5  # phase 10: steps a replay of the grouped graph
RUN_SHOTS = 16  # phase 11: Synthetic's 10 classes x 16 shots, 40 steps an epoch at batch 4
RUN_EPOCHS = 2
# Slice logits, kernel vs plain attention in every layer: the two differ
# by bf16 rounding flips (summation order) that compound over 12 layers;
# logits are exp(logit_scale) = 14.3 x a cosine (averaged over K pairs
# for RPO), so 5e-2 is a cosine difference of 0.0035.  Argmax may flip
# only where two classes' logits are that close.
SLICE_ATOL = 5e-2
SLICE_ARGMAX_AGREE = 0.98
# CoOp and zero-shot logits are one cosine each, not a mean over K pairs,
# so the same per-layer rounding flips move them about sqrt(K) = 5x more
# than RPO's (max 1.5e-2 against 2.8e-3 on the H100), while random
# weights leave a median top-2 margin of 0.015: 4 of 300 argmax flipped
# for CoOp on the card.  A kernel fault would break SLICE_ATOL first.
SINGLE_PAIR_ARGMAX_AGREE = 0.97
# A train step against the same step on the plain versions: the
# cross-entropy moves by at most twice the largest logit difference, so
# a loss is held to 2 x SLICE_ATOL.  A prompt gradient, through 12 bf16
# layers of both towers on either side, differs by rounding flips: its
# largest error within TRAIN_GRAD_REL of its largest entry and its cosine
# to the plain one >= TRAIN_GRAD_COS (the port's CPU test holds it to the
# JAX gradient with the same bounds).  LP is held to it too, though its
# logits are |f| ~ 30 times larger (the probe's unnormalised output): on
# the H100 (700 W) its epoch 1 is within 8.6e-2 of the plain run, and
# PLANTED_FAULTS move its first 10 losses by 0.114 and 0.227.
TRAIN_LOSS_ATOL = 2 * SLICE_ATOL
TRAIN_GRAD_REL = 0.1
TRAIN_GRAD_COS = 0.99
# CoCoOp conditions every class's context on the image feature through the
# meta-net, so a rounding flip in the vision tower moves all 51 text
# features of an image, not only its side of the cosine.  On random weights
# two bf16 runs then disagree about as much as either does with the same
# path in float32 (on the H100, second draw: 32-36 of 300 argmaxes), so an
# argmax bar between two bf16 runs that differ in the vision tower holds
# neither to anything.  Those runs are held to an f32 witness instead,
# against the all-plain run, by a sign test: of the images where exactly
# one of the two has the witness's argmax, the plain run may win more often
# by at most WITNESS_SIGMAS standard deviations of a fair coin (three, for
# the six such tests of a run).  The text side alone (the fused kernel
# against its plain version, on the same image features) keeps
# SINGLE_PAIR_ARGMAX_AGREE.
WITNESS_SIGMAS = 3.0
# INPUT.DEVICE_RESIZE's augmentation in uint8 steps, on the card against
# the same function on the CPU and against the host's Pillow-exact
# resample: the three round after each pass, and where a pass's float32
# sum lands within rounding of a half step (on the main_K24 crops, 5e-5 of
# the first pass's values are exact ties and 2.2e-4 within 1e-4 of one)
# the order of the sums, or Pillow's fixed point, decides: one step a
# pass, two in all.  On the H100, an epoch of the loader's 160 crops at
# 224: card vs CPU 6.82e-4 of the values apart, card vs host 1.10e-3,
# both at most two steps; the planted faults 0.511 (flips dropped) and
# 0.996 (boxes ignored).  So at most PREP_STEPS, on at most PREP_SHARE.
PREP_STEPS = 2
PREP_SHARE = 5e-3
# Zero-shot text features are unit vectors of 512 components of about
# 0.04 each; kernel vs plain attention over 12 bf16 layers moves a
# component by rounding flips only, so 1e-2 is a quarter of one.
UNIT_ATOL = 1e-2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def bound(n_bytes: float, n_flops: float, bw: float, peak: float):
    """(bound ms, "bytes" or "operations") for the card's peaks."""
    bytes_ms, flops_ms = n_bytes / bw * 1e3, n_flops / peak * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def profile_eval_step(step, images, smi: str, label: str, what: str = "eval batch",
                      before=None, ranges=()):
    """One more eval batch (or train step, ``what``) under torch.profiler:
    device time by kernel group, the device's idle share of its wall time
    and the count of device operations.  ``before`` runs after the warm-up,
    just before the profiled step.  ``ranges`` names labelled ranges
    (``record_function``) whose device time is printed beside the groups.
    A window with no device time is taken again, up to three times
    (``before`` before each).  Returns the device operations the profiler
    saw, by group (empty where it saw no device time), and the device's
    busy milliseconds (0 there)."""
    from torch.profiler import ProfilerActivity, profile

    from rpo_tpu_torch.tools.timing import kernel_group

    step(images)  # warm
    torch.cuda.synchronize()
    for _ in range(3):
        if before is not None:
            before()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step(images)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        groups, counts, in_range = {}, {}, {}
        for evt in prof.key_averages():
            if evt.key in ranges:
                # a range shows as the CPU op, whose device time is its
                # kernels', and as a span on the device's timeline (kept out)
                if evt.device_type == torch.autograd.DeviceType.CPU:
                    in_range[evt.key] = getattr(evt, "device_time_total", 0)
                continue
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            group = kernel_group(evt.key)
            groups[group] = groups.get(group, 0.0) + evt.self_device_time_total
            counts[group] = counts.get(group, 0) + evt.count
        if sum(groups.values()) > 0:
            break
    busy, n_ops = sum(groups.values()), sum(counts.values())
    if busy == 0:
        print(f"profile {label}: the profiler saw no device time (not measured)")
        return {}, 0.0
    parts = ", ".join(f"{g} {us / 1e3:.2f} ms ({us / busy:.1%})"
                      for g, us in sorted(groups.items(), key=lambda kv: -kv[1]))
    labelled = "".join(f"; {name} (labelled range) {in_range.get(name, 0) / 1e3:.2f} ms "
                       f"({in_range.get(name, 0) / busy:.1%})" for name in ranges)
    print(f"profile {label} {what} on {smi}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {max(0.0, 1 - busy / wall_us):.1%}, {n_ops} device "
          f"operations (kernels and copies); {parts}{labelled}", flush=True)
    return counts, busy / 1e3


def run_batches(step, batches):
    """Logits and host seconds of each batch, synchronised."""
    batch_s, logits = [], []
    for images in batches:
        t = time.perf_counter()
        out = step(images)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t)
        logits.append(out)
    return logits, batch_s


def check_logits(label: str, logits, plain, min_agree: Optional[float] = SLICE_ARGMAX_AGREE,
                 stop: bool = True, against: str = "plain attention",
                 atol: float = SLICE_ATOL) -> bool:
    """Logits finite, each of its plain batch's shape ((100, 51) in phases
    4-9), and within ``atol`` of the plain run's (the run named by
    ``against``), with argmax agreement >= ``min_agree`` unless it is None
    (then the agreement is only printed); on a disagreement exits, or with
    ``stop`` False returns False."""
    for out, ref in zip(logits, plain):
        if tuple(out.shape) != tuple(ref.shape) or not bool(torch.isfinite(out).all()):
            fail(f"{label} logits have shape {tuple(out.shape)} or are not finite")
    mine, plain = torch.cat(logits), torch.cat(plain)
    diff = (mine - plain).abs().max().item()
    flips = int((mine.argmax(-1) != plain.argmax(-1)).sum())
    agree = 1.0 - flips / mine.shape[0]
    top2 = plain.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).median().item()
    ok = diff <= atol and (min_agree is None or agree >= min_agree)
    bar = "held to the f32 witness below" if min_agree is None else f">= {min_agree}"
    print(f"{label}: logits {tuple(logits[0].shape)} x {len(logits)} finite; vs {against} "
          f"max_abs_err {diff:.3e} (tol {atol:.4g}), argmax agree {agree:.4f} ({flips} of "
          f"{mine.shape[0]} flip; {bar}) {'ok' if ok else 'FAIL'}; logit range "
          f"[{mine.min().item():.3f}, {mine.max().item():.3f}], median top-2 margin {margin:.4f}",
          flush=True)
    if not ok and stop:
        fail(f"{label} logits disagree with the run on {against}")
    return ok


def cocoop_checks(label: str, cocoop, clip, batches, logits) -> None:
    """CoCoOp's logits against the same path on both plain versions, on the
    text side's alone and on the vision side's alone, each within
    SLICE_ATOL, the text side alone also at SINGLE_PAIR_ARGMAX_AGREE; then
    every run against an f32 witness, the same weights, images and path in
    float32 on the plain versions: each run with a kernel in it no further
    from the witness's argmax than the all-plain run (WITNESS_SIGMAS)."""
    from rpo_tpu_torch.data.transforms import (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD,
                                               device_normalize_fn)
    from rpo_tpu_torch.methods.cocoop import cocoop_logits, eval_chunk
    from rpo_tpu_torch.models.clip.model import cast_params
    from rpo_tpu_torch.ops import fused_text_layer as ftl
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    runs, failed = {"kernels": logits}, []
    for what, rect_attn, text_layer, min_agree in (
        ("both plain", ra.rect_attention_reference, ftl.fused_text_layer_reference, None),
        ("text side plain", ra.rect_attention, ftl.fused_text_layer_reference,
         SINGLE_PAIR_ARGMAX_AGREE),
        ("vision side plain", ra.rect_attention_reference, ftl.fused_text_layer, None),
    ):
        runs[what] = [cocoop.eval_step(images, rect_attn=rect_attn, text_layer=text_layer)
                      for images in batches]
        if not check_logits(f"{label} [{what}]", logits, runs[what], min_agree, stop=False):
            failed.append(what)
    clip32 = cast_params(clip, torch.float32)
    normalize32 = device_normalize_fn(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=torch.float32)
    with torch.no_grad():
        witness = torch.cat([cocoop_logits(
            cocoop.params, clip32, cocoop.task, normalize32(torch.from_numpy(images).cuda()),
            chunk=eval_chunk(len(images)), rect_attn=ra.rect_attention_reference,
            text_layer=ftl.fused_text_layer_reference, masked_attn=ma.masked_attention_reference)
            for images in batches])
    top = witness.argmax(-1)
    top2 = witness.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).median().item()
    right = {what: torch.cat(out).argmax(-1) == top for what, out in runs.items()}
    parts = []
    for what, out in runs.items():
        diff = (torch.cat(out) - witness).abs()
        part = (f"{what} {int((~right[what]).sum())} flips, max abs {diff.max().item():.3e}, "
                f"mean abs {diff.mean().item():.3e}")
        if what != "both plain":  # a run with a kernel in it, by the sign test
            a = int((right["both plain"] & ~right[what]).sum())
            b = int((right[what] & ~right["both plain"]).sum())
            limit = WITNESS_SIGMAS * math.sqrt(max(a + b, 1))
            part += (f" (plain alone right on {a}, this run alone on {b}: {a - b} <= "
                     f"{limit:.2f} {'ok' if a - b <= limit else 'FAIL'})")
            if a - b > limit:
                failed.append(f"{what} against the witness")
        parts.append(part)
    print(f"{label} against an f32 witness (the same weights, images and path in float32 on "
          f"the plain versions, median top-2 margin {margin:.4f}), of {len(top)} argmaxes: "
          + "; ".join(parts), flush=True)
    if failed:
        fail(f"{label}: {', '.join(failed)} disagree")


def check_launches(label: str, module, want: int) -> int:
    if module.launches != want:
        fail(f"{label}: {module.__name__.rsplit('.', 1)[-1]} launched {module.launches} times, "
             f"expected {want}")
    return module.launches


def report_rate(label: str, setup_s: float, batch_s, smi: str) -> float:
    med = statistics.median(batch_s)
    print(f"{label} eval on {smi}: setup {setup_s:.2f} s; batch seconds "
          f"{[round(s, 4) for s in batch_s]}; {EVAL_BATCH / med:.1f} images/s at the median batch, "
          f"{EVAL_BATCH * len(batch_s) / sum(batch_s):.1f} over all {len(batch_s)}", flush=True)
    return EVAL_BATCH / med


def run_cli(argv):
    """``rpo_tpu_torch.cli.main`` in this process (so that the launch
    counters can be read); returns (trainer, its log text).  The logger's
    tee of stdout is undone afterwards."""
    from rpo_tpu_torch import cli

    stdout = sys.stdout
    try:
        trainer = cli.main(cli.build_parser().parse_args(argv))
    finally:
        sys.stdout = stdout
    with open(os.path.join(trainer.output_dir, "log.txt")) as f:
        return trainer, f.read()


def check_replay_kernels(label: str, step, arg, n: int, smi: str, rect_step: int,
                         masked_step: int = 0) -> float:
    """A replay of an n-step graph under torch.profiler (``step(arg)``):
    its rect- and masked-kernel device operations must be the ``rect_step``
    and ``masked_step`` launches a step that the capture recorded, n times
    (RPO: 2 x 12 rect, no masked; a replay calls no wrapper, so only the
    profiler sees its kernels run).  Returns the replay's device busy
    milliseconds."""
    seen, busy_ms = profile_eval_step(step, arg, smi, label, f"train, {n}-step graph replay")
    rect, masked = seen.get("rect_attention kernel", 0), seen.get("masked_attention kernel", 0)
    want = (rect_step * n, masked_step * n)
    ok = (rect, masked) == want
    print(f"{label}, {n}-step graph, profiled replay: {rect} rect-kernel and {masked} "
          f"masked-kernel device operations = ({rect_step}, {masked_step}) a step x {n} steps "
          f"(want {want}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}: a replay of the {n}-step graph ran {rect} rect and {masked} masked "
             f"kernels on the device, expected {want}")
    return busy_ms


def graphed_train(rpo, train_batches, first_prompts, eager_losses, eager_prompts,
                  eager_rate: float, smi: str, n_layers: int):
    """Phase 10's graphed step: from the first prompts and a fresh
    optimizer, ten replays of the one-step graph and two of the
    GRAPH_GROUP-step graph through the engine's hooks, against the ten
    eager steps (losses and prompts ``torch.equal``, else within the
    train bound with the gap printed); the rect launches the wrappers
    counted (the warm-up step and the capture) and those a profiled
    replay ran on the device (24 a step); train images/s at the median
    of N_TRAIN_TIMED replays after TRAIN_WARMUP, beside the eager step's.
    Returns the rect launches by path and the replayed ones (captured x
    replays)."""
    from rpo_tpu_torch.methods.step_graph import WARMUP_STEPS, batch_spec
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    batches = [{"img": b[0], "label": b[1], "mask": b[2]} for b in train_batches]
    checked = batches[:N_TRAIN_CHECK]
    rpo.current_lr = TRAIN_LR
    launches, replayed, rates = {}, {}, {"eager": eager_rate}
    for n in (1, GRAPH_GROUP):
        rpo.set_ckpt_state(rpo.model_name, first_prompts)  # in place: a fresh optimizer
        ra.launches = ma.launches = 0
        t0 = time.perf_counter()
        losses = torch.stack([s["loss"] for i in range(0, N_TRAIN_CHECK, n)
                              for s in rpo.forward_backward_multi(checked[i:i + n])])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        graph = rpo._graphs[(n, batch_spec(checked[0]))]
        per_replay = graph.launches_per_replay["rect_attention.launches"]
        want = 2 * n_layers * (WARMUP_STEPS + n)
        same = bool(torch.equal(losses, eager_losses)) and all(
            torch.equal(t, eager_prompts[key]) for key, t in rpo.params.items())
        err = (losses - eager_losses).abs().max().item()
        p_err = max((t - eager_prompts[key]).abs().max().item() for key, t in rpo.params.items())
        ok = ra.launches == want and per_replay == 2 * n_layers * n and ma.launches == 0 and \
            graph.replays == N_TRAIN_CHECK // n and err <= TRAIN_LOSS_ATOL
        print(f"slice RPO train, {n}-step graph: {graph.replays} replays of {n} step(s) from "
              f"the first prompts against the {N_TRAIN_CHECK} eager "
              f"steps: losses and prompts {'torch.equal' if same else 'NOT equal'} (losses "
              f"max_abs_err {err:.3e}, tol {TRAIN_LOSS_ATOL:g}; prompts {p_err:.3e}); rect "
              f"launches counted {ra.launches} = 2 x {n_layers} x ({WARMUP_STEPS} warm-up step + "
              f"{n} captured), {per_replay} recorded a replay; replayed {per_replay} x "
              f"{graph.replays} = {per_replay * graph.replays}; masked {ma.launches}; capture "
              f"and replays {first_s:.2f} s {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"RPO train: the {n}-step graph disagrees with the eager steps or its launches")
        launches[f"RPO train, {n}-step graph"] = ra.launches
        replayed[f"RPO train, {n}-step graph"] = per_replay * graph.replays
        groups = [[batches[(i * n + j) % len(batches)] for j in range(n)]
                  for i in range(TRAIN_WARMUP + N_TRAIN_TIMED)]
        for group in groups[:TRAIN_WARMUP]:
            rpo.forward_backward_multi(group)
        replay_s = []
        for group in groups[TRAIN_WARMUP:]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            rpo.forward_backward_multi(group)
            torch.cuda.synchronize()
            replay_s.append(time.perf_counter() - t)
        med = statistics.median(replay_s)
        rates[f"{n}-step graph"] = TRAIN_BATCH * n / med
        print(f"RPO train, {n}-step graph on {smi}: replay seconds median {med:.5f} (min "
              f"{min(replay_s):.5f}, max {max(replay_s):.5f}, {len(replay_s)} replays after "
              f"{TRAIN_WARMUP} warm-up, each from the host's uint8 batches to the updated "
              f"prompts); {TRAIN_BATCH * n / med:.1f} train images/s at the median replay, "
              f"{TRAIN_BATCH * n * len(replay_s) / sum(replay_s):.1f} over all", flush=True)
        busy_ms = check_replay_kernels("RPO train", rpo.forward_backward_multi, groups[-1], n, smi,
                                       2 * n_layers)
        # the profiler's own cost stretches a traced replay's wall time
        print(f"RPO train, {n}-step graph: the profiled replay's device busy {busy_ms:.2f} ms "
              f"against the median untraced replay's {med * 1e3:.2f} ms: idle share "
              f"{max(0.0, 1 - busy_ms / (med * 1e3)):.1%} of an untraced replay", flush=True)
    print(f"RPO train on {smi}, train images/s (median): " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    return launches, replayed


def run_argv(out: str, extra=()) -> list:
    """The CLI's arguments for main_K24 on Synthetic (RUN_SHOTS shots of 10
    classes, RUN_EPOCHS epochs, seed 1), output under ``out``."""
    root = os.path.dirname(os.path.abspath(__file__))
    return ["--seed", "1", "--trainer", "RPO",
            "--dataset-config-file", os.path.join(root, "configs/datasets/synthetic.yaml"),
            "--config-file", os.path.join(root, "configs/trainers/RPO/main_K24.yaml"),
            "--output-dir", out,
            "DATASET.NUM_SHOTS", str(RUN_SHOTS), "OPTIM.MAX_EPOCH", str(RUN_EPOCHS), *extra]


def rpo_expect(n_layers: int, text_layers: int) -> dict:
    """The kernels an RPO CLI run launches (``cli_train``'s ``expect``):
    24 rect a step (the frozen and the prompt rows of each layer), 12 rect
    an eval batch, 12 masked once (the text K/V cache at the build)."""
    return {"model": "prompt_learner", "step": (2 * n_layers, 0), "eval": (n_layers, 0),
            "setup_masked": text_layers}


def cli_train(argv, smi: str, label: str, expect: dict):
    """A CLI training run of ``argv`` with every step's loss and the wall
    clock around epoch 2's steps recorded, both engine hooks (a group's
    losses come from ``forward_backward_multi``); the launches the wrappers
    counted from 0 against ``expect`` (``rpo_expect``'s keys: the saved
    model's name, the (rect, masked) launches of a step, the (rect, fused
    text) launches of an eval batch and the masked launches of the text
    set-up): each captured graph's warm-up step and captured steps, the
    test batches and the set-up; the launches the graphs recorded against
    the run's steps; the log contract; then a third epoch's batches and a
    profiled replay of each graph on them, whose kernels on the device
    must be the capture's.  Returns (trainer, log, the step losses on the
    host, the engine's images/s over epoch 2, the final test's accuracy
    line, the third epoch's batches, the launches replayed by kernel:
    recorded x replays, and the run's first batch with the tensors its
    step reads and writes as they were before it)."""
    from rpo_tpu_torch.methods.base_trainer import CLIPMethodTrainer
    from rpo_tpu_torch.methods.step_graph import WARMUP_STEPS
    from rpo_tpu_torch.ops import fused_rect_layer as frl
    from rpo_tpu_torch.ops import fused_text_layer as ftl
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    losses, stamps, first = [], [], {}
    single, multi = CLIPMethodTrainer.forward_backward, CLIPMethodTrainer.forward_backward_multi

    def keep_first(self, batch) -> None:
        if not first:
            first["batch"] = {k: v.copy() if isinstance(v, np.ndarray) else v
                              for k, v in batch.items()}
            first["state"] = [t.detach().clone() for t in self._graph_bound()
                              if isinstance(t, torch.Tensor)]

    def stamp(self, at_start: bool) -> None:
        n = len(self.dm.train_loader_x)
        if len(losses) == (n if at_start else RUN_EPOCHS * n):  # epoch 2's first / last step
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    def one(self, batch):
        keep_first(self, batch)
        stamp(self, True)
        summary = single(self, batch)
        losses.append(summary["loss"])
        stamp(self, False)
        return summary

    def group(self, batches):
        keep_first(self, batches[0])
        stamp(self, True)
        summaries = multi(self, batches)
        losses.extend(s["loss"] for s in summaries)
        stamp(self, False)
        return summaries

    CLIPMethodTrainer.forward_backward, CLIPMethodTrainer.forward_backward_multi = one, group
    ra.launches = ma.launches = ftl.launches = frl.attn_half_launches = frl.mlp_half_launches = 0
    try:
        trainer, log = run_cli(argv)
        torch.cuda.synchronize()
    finally:
        CLIPMethodTrainer.forward_backward, CLIPMethodTrainer.forward_backward_multi = single, multi
    n_steps, n_eval = len(trainer.dm.train_loader_x), len(trainer.dm.test_loader)
    graphs = list(trainer._graphs.values())
    (rect_step, masked_step), (rect_eval, fused_eval) = expect["step"], expect["eval"]
    counted_steps = sum(WARMUP_STEPS + g.n_steps for g in graphs)
    want = (rect_step * counted_steps + rect_eval * n_eval,
            masked_step * counted_steps + expect["setup_masked"], fused_eval * n_eval)
    captured = [(g.n_steps, g.replays, g.launches_per_replay["rect_attention.launches"],
                 g.launches_per_replay["masked_attention.launches"]) for g in graphs]
    replayed = {"rect": sum(k * r for _, k, r, _ in captured),
                "masked": sum(k * m for _, k, _, m in captured)}
    print(f"{label} launches: rect {ra.launches}, masked {ma.launches}, fused text "
          f"{ftl.launches} = ({rect_step}, {masked_step}, 0) a step x {counted_steps} steps (each "
          f"graph's {WARMUP_STEPS} warm-up step and its captured steps, {len(graphs)} graph(s)) + "
          f"({rect_eval}, 0, {fused_eval}) x {n_eval} eval batch(es) + (0, "
          f"{expect['setup_masked']}, 0) text set-up = {want}; graphs (steps, replays, rect and "
          f"masked launches recorded a replay) {captured}: replayed (recorded x replays) "
          f"{replayed} over {RUN_EPOCHS} x {n_steps} steps; fused rect halves "
          f"{frl.attn_half_launches + frl.mlp_half_launches}", flush=True)
    if (ra.launches, ma.launches, ftl.launches) != want or \
            frl.attn_half_launches or frl.mlp_half_launches or not graphs or \
            any((r, m) != (rect_step * n, masked_step * n) for n, _, r, m in captured) or \
            sum(n * k for n, k, _, _ in captured) != RUN_EPOCHS * n_steps:
        fail(f"{label}: the launches are not those of its steps, graphs and eval batches")
    contract = ("Finish training", "=> result", "* accuracy:", "* total:", "* correct:",
                "* macro_f1:")
    missing = [line for line in contract if line not in log]
    step_losses = torch.stack(losses).float().cpu()
    logged = [float(x) for x in re.findall(r" loss ([-+\d.eEnaif]+) \(", log)]
    ckpt = os.path.join(trainer.output_dir, expect["model"], f"model.pth.tar-{RUN_EPOCHS}")
    if missing or len(losses) != RUN_EPOCHS * n_steps or not bool(torch.isfinite(step_losses).all()) \
            or not logged or not all(math.isfinite(x) for x in logged) or not os.path.exists(ckpt):
        fail(f"{label}: contract lines missing {missing}, {len(losses)} steps, losses finite "
             f"{bool(torch.isfinite(step_losses).all())}, logged {logged}, checkpoint "
             f"{os.path.exists(ckpt)}")
    accuracy = re.findall(r"\* accuracy: ([\d.]+)%", log)
    cfg = trainer.cfg
    batch_size = int(cfg.DATALOADER.TRAIN_X.BATCH_SIZE)
    engine_rate = batch_size * n_steps / (stamps[1] - stamps[0])
    config = os.path.relpath(argv[argv.index("--config-file") + 1],
                             os.path.dirname(os.path.abspath(__file__)))
    print(f"{label} (CLI, {config}, {cfg.DATASET.NAME} {len(trainer.dm.classnames)} classes x "
          f"{cfg.DATASET.NUM_SHOTS} shots, batch {batch_size}, {RUN_EPOCHS} epochs of {n_steps} "
          f"steps, {cfg.MODEL.BACKBONE.NAME} PREC {trainer.cfg_prec(cfg)}, STEPS_PER_DISPATCH "
          f"{int(cfg.TRAIN.STEPS_PER_DISPATCH)}, DEVICE_RESIZE {int(cfg.INPUT.DEVICE_RESIZE)}): "
          f"losses finite, epoch means "
          f"{[round(x, 4) for x in step_losses.view(RUN_EPOCHS, -1).mean(1).tolist()]}; "
          f"the log's contract lines present; {os.path.basename(ckpt)} written; final test "
          f"accuracy {accuracy}", flush=True)
    means = re.findall(r"epoch \[(\d)/\d\] batch \[(\d+)/\d+\] time [\d.]+ \(([\d.]+)\) data "
                       r"[\d.]+ \(([\d.]+)\)", log)
    for epoch, batch, step_mean, data_mean in means:
        if int(batch) == n_steps:
            print(f"{label} engine means, epoch {epoch}: step time {step_mean} s, data time "
                  f"{data_mean} s (the log's own means)", flush=True)
    print(f"{label} on {smi}: {engine_rate:.1f} train images/s over epoch 2 (the engine's loop, "
          f"{n_steps} steps synchronised at both ends, data included)", flush=True)
    # a third epoch's batches (the trainable tensors move on; the checkpoint
    # is written): a profiled replay of each graph the run captured
    made = list(trainer.dm.train_loader_x)
    for g in graphs:
        step = trainer.forward_backward_multi if g.n_steps > 1 else (
            lambda group: trainer.forward_backward(group[0]))
        check_replay_kernels(label, step, made[:g.n_steps], g.n_steps, smi, rect_step,
                             masked_step)
    return trainer, log, step_losses, engine_rate, accuracy, made, replayed, first


def eval_only_check(out: str, label: str, trainer, argv, accuracy, n_layers: int,
                    text_layers: int):
    """An eval-only run of the training run's last checkpoint under
    ``out``/eval: the same accuracy, 12 rect launches a test batch and one
    text set-up; then the last test batch's logits against both plain
    versions at phase 4's bounds.  Returns the evaluating trainer and its
    launches."""
    from rpo_tpu_torch.methods import rpo as rpo_core
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    ra.launches = ma.launches = 0
    i = argv.index("--output-dir")
    evaluator, eval_log = run_cli(argv[:i] + [
        "--output-dir", os.path.join(out, "eval"), "--eval-only",
        "--model-dir", trainer.output_dir, "--load-epoch", str(RUN_EPOCHS)] + argv[i + 2:])
    torch.cuda.synchronize()
    launches = (ra.launches, ma.launches)
    n_eval = len(evaluator.dm.test_loader)
    eval_accuracy = re.findall(r"\* accuracy: ([\d.]+)%", eval_log)
    ok = eval_accuracy == accuracy and len(accuracy) == 1 and \
        launches == (n_layers * n_eval, text_layers)
    print(f"{label} eval-only (--load-epoch {RUN_EPOCHS}): accuracy {eval_accuracy} against the "
          f"final test's {accuracy}; launches rect {ra.launches}, masked {ma.launches} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}: the eval-only run does not reproduce the final test")
    # the last test batch from the loaded checkpoint: kernels against the
    # plain versions (a text K/V cache built with the plain masked attention)
    images = [b for b in evaluator.dm.test_loader][-1]["img"]
    logits = evaluator.eval_step(images)
    kernel_frozen = evaluator._frozen
    evaluator._frozen = rpo_core.make_frozen(evaluator.clip_params, evaluator.task,
                                             masked_attn=ma.masked_attention_reference)
    evaluator._text_f_cache = None
    plain = evaluator.eval_step(images, rect_attn=ra.rect_attention_reference,
                                masked_attn=ma.masked_attention_reference)
    evaluator._frozen, evaluator._text_f_cache = kernel_frozen, None
    diff = (logits.float() - plain.float()).abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    ok = bool(torch.isfinite(logits).all()) and diff <= SLICE_ATOL and agree >= SLICE_ARGMAX_AGREE
    print(f"{label} checkpoint, last test batch {tuple(logits.shape)}: vs both plain versions "
          f"max_abs_err {diff:.3e} (tol {SLICE_ATOL}), argmax agree {agree:.4f} (>= "
          f"{SLICE_ARGMAX_AGREE}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}: the checkpoint's logits disagree with the plain versions")
    return evaluator, launches


def rpo_run(out: str, smi: str, phase10_rate: float, n_layers: int, text_layers: int) -> dict:
    """Phase 11: RPO trained by the CLI, main_K24 on Synthetic (10 classes,
    16 shots: 40 steps an epoch at batch 4), ViT-B/16 in bf16, seed 1, two
    epochs, each step one replay of the one-step graph, then the final
    test; an eval-only run of the checkpoint; the last test batch's logits
    and epoch 1's losses against the plain versions, all under the
    directory ``out``.  Returns the launches by path, epoch 1's losses and
    the engine's rate and means."""
    from rpo_tpu_torch.cli import set_random_seed
    from rpo_tpu_torch.engine import build_trainer
    from rpo_tpu_torch.engine.optim import lr_at_epoch
    from rpo_tpu_torch.methods import rpo as rpo_core
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    argv = run_argv(os.path.join(out, "train"))
    trainer, log, step_losses, engine_rate, accuracy, made, replayed, _ = cli_train(
        argv, smi, "RPO run", rpo_expect(n_layers, text_layers))
    launches = {"rect": {"RPO run": ra.launches}, "masked": {"RPO run": ma.launches},
                "rect_replayed": {"RPO run": replayed["rect"]}}
    n_steps = len(trainer.dm.train_loader_x)
    batch_size = int(trainer.cfg.DATALOADER.TRAIN_X.BATCH_SIZE)
    print(f"RPO run on {smi}: {engine_rate:.1f} train images/s over epoch 2 against phase 10's "
          f"{phase10_rate:.1f} (the trainer's eager step alone, median of {N_TRAIN_TIMED}) in this "
          f"call", flush=True)
    # the engine's step over a third epoch's batches made beforehand: the
    # same loop without the loader's threads beside it (the prompts move
    # on; the checkpoint is already written)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in made:
        trainer.forward_backward(batch)
    torch.cuda.synchronize()
    bare_rate = batch_size * len(made) / (time.perf_counter() - t0)
    print(f"RPO run on {smi}: {bare_rate:.1f} train images/s over {len(made)} steps of batches "
          f"made beforehand (the engine's step on host batches, no loader threads), against "
          f"{engine_rate:.1f} with the loader", flush=True)
    evaluator, (rect, masked) = eval_only_check(out, "RPO run", trainer, argv, accuracy, n_layers,
                                                text_layers)
    launches["rect"]["RPO run, eval-only"] = rect
    launches["masked"]["RPO run, eval-only"] = masked
    del trainer

    # epoch 1 again on the plain versions, eagerly: the same seed, so the
    # same few-shot draw, batches and first prompts; the warm-up LR
    set_random_seed(1)
    plain = build_trainer(evaluator.cfg.clone(), clip_params=evaluator.clip_params,
                          device=evaluator.device)
    del evaluator
    plain._frozen = rpo_core.make_frozen(plain.clip_params, plain.task,
                                         masked_attn=ma.masked_attention_reference)
    lr = lr_at_epoch(plain.cfg.OPTIM, 0)
    refs = dict(rect_attn=ra.rect_attention_reference, masked_attn=ma.masked_attention_reference)
    p_losses = torch.stack([plain.train_step(b["img"], b["label"], b["mask"], lr, **refs)[0]
                            for b in plain.dm.train_loader_x]).float().cpu()
    err = (step_losses[:n_steps] - p_losses).abs().max().item()
    ok = len(p_losses) == n_steps and err <= TRAIN_LOSS_ATOL
    print(f"RPO run epoch 1 ({n_steps} steps at LR {lr:g}) vs the same epoch on both plain "
          f"versions: max_abs_err {err:.3e} (tol {TRAIN_LOSS_ATOL:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("RPO run: epoch 1's losses disagree with the plain run")
    del plain
    return {"launches": launches, "losses": step_losses[:n_steps], "rate": engine_rate,
            "log": log}


def device_resize_check(label: str, trainer, batches) -> None:
    """INPUT.DEVICE_RESIZE's augmentation on the card, on the loader's
    own sources, boxes and flips (``batches``), compared in uint8 steps
    (the normalisation undone and rounded):

    - against the same function on the CPU, which the CPU tests hold to
      the JAX package's (they differ in the order of the float32 sums);
    - against the host's resample (``data.transforms.resample``, Pillow's
      bytes) of the crop, then the flip, as the host path does it
      (Pillow sums in 22-bit fixed point; the JAX suite holds its device
      resize to Pillow within two steps, tests/test_device_resize_path.py);

    each at most PREP_STEPS apart on at most PREP_SHARE of the values; and
    planted faults must fail the host check: the flips dropped, the boxes
    replaced by the full frame."""
    from rpo_tpu_torch.data.transforms import resample
    from rpo_tpu_torch.ops.preprocess import _mean_std_u8, device_train_preprocess

    size, cfg = trainer.clip_cfg.image_resolution, trainer.cfg.INPUT
    img = torch.as_tensor(np.concatenate([b["img"] for b in batches]))
    box = torch.as_tensor(np.concatenate([b["box"] for b in batches]))
    flip = torch.as_tensor(np.concatenate([b["flip"] for b in batches]))

    def u8(device, boxes=box, flips=flip):
        m, s = _mean_std_u8(cfg.PIXEL_MEAN, cfg.PIXEL_STD, device)
        x = device_train_preprocess(img.to(device), boxes.to(device), flips.to(device), size,
                                    m, s)
        return torch.round(x * s + m).cpu()

    host = []
    for src, (left, top, cw, ch), flipped in zip(img.numpy(), box.tolist(), flip.tolist()):
        out = resample(src, (size, size), "bicubic", box=(left, top, left + cw, top + ch))
        host.append(out[:, ::-1] if flipped else out)
    host = torch.from_numpy(np.stack(host).astype(np.float32))

    def apart(a, b):
        diff = (a - b).abs()
        return diff.max().item(), int((diff > 0).sum()), diff.numel()

    card = u8(trainer.device)
    checks = [("the same function on the CPU", apart(card, u8("cpu"))),
              ("the host's resample", apart(card, host))]
    full = torch.tensor([0, 0, img.shape[2], img.shape[1]], dtype=box.dtype).expand_as(box)
    planted = [("flips dropped", apart(u8(trainer.device, flips=torch.zeros_like(flip)), host)),
               ("boxes ignored", apart(u8(trainer.device, boxes=full), host))]
    ok = all(mx <= PREP_STEPS and off <= PREP_SHARE * n for _, (mx, off, n) in checks) and \
        all(mx > PREP_STEPS or off > PREP_SHARE * n for _, (mx, off, n) in planted)
    print(f"{label}: device augmentation of {len(img)} loader images ({int(flip.sum())} "
          f"flipped, {int((box[:, 2] < img.shape[2]).sum())} cropped) to {size} x {size} on the "
          f"card, in uint8 steps: " + "; ".join(
              f"vs {what}: max {mx:g} (<= {PREP_STEPS}), {off} of {n} values apart "
              f"({off / n:.2e}, <= {PREP_SHARE:g})" for what, (mx, off, n) in checks) +
          "; planted faults vs the host (must fail): " + "; ".join(
              f"{what}: max {mx:g}, {off / n:.2e} apart" for what, (mx, off, n) in planted) +
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}: the device augmentation disagrees with the host's, or a planted fault "
             "passes")


def rpo_run_one_dispatch(out: str, smi: str, phase11: dict, n_layers: int,
                         text_layers: int) -> dict:
    """Phase 12: phase 11's run with TRAIN.STEPS_PER_DISPATCH 4 (ten
    replays of the four-step graph an epoch), epoch 1's losses against
    phase 11's on the same batches; then the same with INPUT.DEVICE_RESIZE
    224 (the sources, boxes and flips go to the device, where the step
    crops, resizes and flips them): the log contract, finite losses, the
    device augmentation against the host's resample on the loader's
    boxes and flips (``device_resize_check``), the eval-only accuracy and
    the checkpoint's logits against both plain versions.  Each run's
    engine rate and means beside phase 11's.  Returns the launches by
    path and the rect launches replayed."""
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    launches = {"rect": {}, "masked": {}, "rect_replayed": {}}
    n = len(phase11["losses"])
    p11_means = re.findall(r"epoch \[2/\d\] batch \[(\d+)/(\d+)\] time [\d.]+ \(([\d.]+)\) "
                           r"data [\d.]+ \(([\d.]+)\)", phase11["log"])
    p11_means = [(step, data) for b, nb, step, data in p11_means if b == nb]
    for label, extra in (("RPO run, one dispatch", ["TRAIN.STEPS_PER_DISPATCH", "4"]),
                         ("RPO run, one dispatch, DEVICE_RESIZE 224",
                          ["TRAIN.STEPS_PER_DISPATCH", "4", "INPUT.DEVICE_RESIZE", "224"])):
        sub = os.path.join(out, label.rsplit(", ", 1)[-1].replace(" ", "_"))
        argv = run_argv(os.path.join(sub, "train"), extra)
        trainer, log, losses, rate, accuracy, made, replayed, _ = cli_train(
            argv, smi, label, rpo_expect(n_layers, text_layers))
        launches["rect"][label] = ra.launches
        launches["masked"][label] = ma.launches
        launches["rect_replayed"][label] = replayed["rect"]
        gap = (losses[:n] - phase11["losses"]).abs()
        same = bool(torch.equal(losses[:n], phase11["losses"]))
        ok = gap.max().item() <= TRAIN_LOSS_ATOL
        print(f"{label}: epoch 1's {n} losses against phase 11's (one-step graph, the same "
              f"batches): {'equal' if same else 'not equal'}, max_abs_err {gap.max().item():.3e}, "
              f"{int((gap > 0).sum())} differ (tol {TRAIN_LOSS_ATOL:g}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"{label}: epoch 1's losses disagree with phase 11's")
        print(f"{label} on {smi}: {rate:.1f} train images/s over epoch 2 against phase 11's "
              f"{phase11['rate']:.1f}; phase 11's epoch-2 means (step, data) {p11_means}",
              flush=True)
        if "DEVICE_RESIZE" in label:
            device_resize_check(label, trainer, made)
            evaluator, (rect, masked) = eval_only_check(sub, label, trainer, argv, accuracy,
                                                        n_layers, text_layers)
            launches["rect"][f"{label}, eval-only"] = rect
            launches["masked"][f"{label}, eval-only"] = masked
            del evaluator
        del trainer
    return launches


# Phase 13: the paper's ViT-B/16 baselines through the CLI on Synthetic, each
# protocol config as its script gives it, cut in shots for the run's time
# (the protocol trains on 16): (label, trainer, config, shots, options)
BASELINES = (
    ("CoOp run", "CoOp", "configs/trainers/CoOp/vit_b16_ep50_ctxv1.yaml", 16, ()),
    ("CoCoOp run", "CoCoOp", "configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml", 4, ()),
    ("CoCoOp run, batch 16", "CoCoOp", "configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml", 4,
     ("DATALOADER.TRAIN_X.BATCH_SIZE", "16")),
    ("LP run", "LP", "configs/trainers/LP/vit_b16_c4_ep10_batch1.yaml", 4, ()),
)
# scripts/zsclip/zeroshot.sh: CoOp's config for the backbone, the new classes
ZERO_SHOT_CONFIG = "configs/trainers/CoOp/vit_b16.yaml"
# LP's epoch 1 on the plain path with a planted fault: its first steps
PLANTED_STEPS = 10


def baseline_argv(out: str, trainer: str, config: str, extra=()) -> list:
    root = os.path.dirname(os.path.abspath(__file__))
    return ["--seed", "1", "--trainer", trainer,
            "--dataset-config-file", os.path.join(root, "configs/datasets/synthetic.yaml"),
            "--config-file", os.path.join(root, config), "--output-dir", out, *extra]


def baseline_expect(trainer: str, batch: int, test_batch: int, n_layers: int,
                    text_layers: int) -> dict:
    """``cli_train``'s ``expect`` for a baseline: CoOp a text tower a step
    (12 masked) over the frozen image tower (12 rect), the text features
    once for the test; CoCoOp 12 rect and the per-image text towers, one
    tower a step below batch 16 and one a chunk of 8 from 16 on, and at
    eval 12 fused text-layer launches a chunk of 10 images; LP 12 rect a
    step, its text features once at the build."""
    from rpo_tpu_torch.methods.cocoop import ACCUM_BATCH, ACCUM_CHUNK, eval_chunk

    if trainer == "CoCoOp":
        chunk = min(ACCUM_CHUNK, batch)
        while batch % chunk:
            chunk -= 1
        towers = batch // chunk if batch >= ACCUM_BATCH else 1
        return {"model": "prompt_learner", "step": (n_layers, text_layers * towers),
                "eval": (n_layers, text_layers * (test_batch // eval_chunk(test_batch))),
                "setup_masked": 0}
    return {"model": "lp_layer" if trainer == "LP" else "prompt_learner",
            "step": (n_layers, text_layers if trainer == "CoOp" else 0), "eval": (n_layers, 0),
            "setup_masked": text_layers}


def grads_close(label: str, grads: dict, want: dict) -> list:
    """Each tensor of two gradient trees (nested dicts) within TRAIN_GRAD_REL
    of the largest entry, cosine >= TRAIN_GRAD_COS; prints each, returns
    the names that fail."""
    failed, parts = [], []

    def walk(path, g, w):
        if isinstance(w, dict):
            for key in w:
                walk(f"{path}.{key}" if path else key, g[key], w[key])
            return
        err = (g.float() - w.float()).abs().max().item()
        big = w.float().abs().max().item()
        cos = F.cosine_similarity(g.flatten().double(), w.flatten().double(), dim=0).item()
        ok = bool(torch.isfinite(g).all()) and err <= TRAIN_GRAD_REL * big and cos >= TRAIN_GRAD_COS
        parts.append(f"{path} {tuple(g.shape)} max_abs_err {err:.3e} (max {big:.3e}), cosine "
                     f"{cos:.6f} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(path)

    walk("", grads, want)
    print(f"{label}: " + "; ".join(parts), flush=True)
    return failed


def replay_equals_eager(label: str, trainer, first: dict) -> None:
    """The run's first step again, on its first batch from the state before
    it (``cli_train``'s ``first``: a loss far from 0, so a gradient that
    moves every trainable tensor), eagerly and as a replay of the run's
    one-step graph at the run's last LR, the state put back in place
    before each: the loss and the trainable tensors ``torch.equal``, else
    within the train bound with the gap printed.  Fails on a loss below
    1e-2 or a trainable tensor the step leaves as it was."""
    from rpo_tpu_torch.engine import optim
    from rpo_tpu_torch.methods.step_graph import state_kept

    lr, batch = trainer.current_lr, first["batch"]
    tensors = [t for t in trainer._graph_bound() if isinstance(t, torch.Tensor)]

    def after(step):
        with state_kept(tensors):
            with torch.no_grad():
                for t, s in zip(tensors, first["state"]):
                    t.copy_(s)
            before = [t.clone() for t in optim.tree_leaves(trainer.params)]
            loss = step()
            params = [t.clone() for t in optim.tree_leaves(trainer.params)]
            return loss.clone(), params, min((a - b).abs().max().item()
                                             for a, b in zip(params, before))

    e_loss, e_params, moved = after(lambda: trainer.train_step(
        trainer._train_images(batch), batch["label"], batch["mask"], lr)[0])
    r_loss, r_params, _ = after(lambda: trainer.forward_backward(batch)["loss"])
    same = torch.equal(e_loss, r_loss) and all(map(torch.equal, e_params, r_params))
    err = abs(e_loss.item() - r_loss.item())
    p_err = max((a - b).abs().max().item() for a, b in zip(e_params, r_params))
    live = e_loss.item() >= 1e-2 and moved > 0
    ok = (same or err <= TRAIN_LOSS_ATOL) and live
    print(f"{label}: the first step again, eagerly and as a replay of the captured one-step graph "
          f"from the state before it, at LR {lr:g}: loss and trainable tensors "
          f"{'torch.equal' if same else 'NOT equal'} (loss {e_loss.item():.6f}, err {err:.3e}; "
          f"tensors {p_err:.3e}; the least largest move of a trainable tensor {moved:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}: the replay disagrees with the eager step, or the step moves nothing")


def profile_backward_share(label: str, trainer, batch, smi: str) -> None:
    """An eager train step under torch.profiler with the attention backward
    (the plain recompute, ``_attention_bwd_math``) in a labelled range: its
    device time against the step's device busy time.  A replay runs the
    same kernels, which the profiler cannot attribute to the range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from rpo_tpu_torch.ops import rect_attention as ra

    name = "attention backward, plain recompute"
    bwd = ra._attention_bwd_math

    def labelled(*args):
        with record_function(name):
            return bwd(*args)

    def step():
        trainer.train_step(trainer._train_images(batch), batch["label"], batch["mask"],
                           trainer.current_lr)
        torch.cuda.synchronize()

    ra._attention_bwd_math = labelled
    try:
        step()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
    finally:
        ra._attention_bwd_math = bwd
    # the range shows twice: as the CPU op, whose device time is its
    # kernels', and as a span on the device's timeline, kept out of both sums
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key != name)
    ranges = [e for e in events
              if e.key == name and e.device_type == torch.autograd.DeviceType.CPU]
    bwd_us = sum(getattr(e, "device_time_total", 0) for e in ranges)
    calls = sum(e.count for e in ranges)
    share = f"{bwd_us / busy:.1%}" if busy and bwd_us else "not measured"
    print(f"{label} eager step on {smi}, profiled: device busy {busy / 1e3:.3f} ms; the "
          f"attention backward (plain recompute, {calls} calls) {bwd_us / 1e3:.3f} ms of it: "
          f"{share}", flush=True)


def lost_key_tiles(full: int):
    """A planted fault for the bounds' controls: the rect attention's plain
    version without its last 16-key tiles, the partial one and ``full``
    full ones before it (of 197 keys, 192-196 for 0 and 176-196 for 1), as
    a kernel that skipped the partial tile (the ``full`` branch of
    ``attention_tc.cuh``) or miscounted its tiles would compute."""
    from rpo_tpu_torch.ops import rect_attention as ra

    def attn(q, k, v):
        n = (k.shape[-2] // 16 - full) * 16
        return ra.rect_attention_reference(q, k[..., :n, :], v[..., :n, :])

    return attn


# LP's controls: (what is lost, the fault); the losses must fail the last
PLANTED_FAULTS = (("the partial key tile", lost_key_tiles(0)),
                  ("the partial and the last full key tile", lost_key_tiles(1)))


def lp_witness_logits(evaluator, images):
    """LP's logits on an f32 witness: the same weights, images and path in
    float32 on the plain versions."""
    from rpo_tpu_torch.data.transforms import (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD,
                                               device_normalize_fn)
    from rpo_tpu_torch.methods.linear_probe import lp_logits, lp_text_features
    from rpo_tpu_torch.models.clip.model import cast_params
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    clip32, cfg = cast_params(evaluator.clip_params, torch.float32), evaluator.clip_cfg
    normalize32 = device_normalize_fn(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=torch.float32)
    x = normalize32(torch.as_tensor(images).to(evaluator.device))
    with torch.no_grad():
        tf = lp_text_features(clip32, cfg, evaluator.classnames, evaluator.prompt,
                              ma.masked_attention_reference)
        return lp_logits(evaluator.params, clip32, cfg, tf, x, ra.rect_attention_reference)


def plain_eval_logits(evaluator, images, rect=None):
    """The batch's logits on both plain versions through the method's own
    path (CoOp, LP, zero-shot): the text features on the plain masked
    attention, the image tower on ``rect`` (the plain rect attention where
    None)."""
    from rpo_tpu_torch.methods import coop as coop_mod
    from rpo_tpu_torch.methods import linear_probe, zsclip
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    rect, masked = rect or ra.rect_attention_reference, ma.masked_attention_reference
    clip, cfg = evaluator.clip_params, evaluator.clip_cfg
    x = evaluator._normalize(torch.as_tensor(images).to(evaluator.device))
    with torch.no_grad():
        if isinstance(evaluator, coop_mod.CoOp):
            tf = coop_mod.coop_text_features(evaluator.params, clip, evaluator.task, masked)
            return coop_mod.coop_logits(evaluator.params, clip, evaluator.task, x, text_f=tf,
                                        rect_attn=rect, masked_attn=masked)
        if isinstance(evaluator, linear_probe.LP):
            tf = linear_probe.lp_text_features(clip, cfg, evaluator.classnames, evaluator.prompt,
                                               masked)
            return linear_probe.lp_logits(evaluator.params, clip, cfg, tf, x, rect)
        tf = zsclip.zeroshot_text_features(clip, cfg, evaluator.text_tokens(), masked)
        return zsclip.zeroshot_logits(clip, cfg, x, tf, rect, masked)


def check_run_logits(label: str, evaluator, images, logits) -> None:
    """The last test batch's logits against both plain versions at phase
    4's bounds (CoCoOp with phase 7's checks and f32 witness).  LP's logits
    are exp(logit_scale) |f| cos(f, t) for the probe's output f on the
    unnormalised image features (|f| ~ 30 on random weights) and unit text
    features t, not a cosine at CLIP's logit scale: its bound is the plain
    path's own distance from an f32 witness (a kernel may move the logits
    no further than bf16 rounding moves the plain path), and the plain path
    with each of PLANTED_FAULTS must break it."""
    from rpo_tpu_torch.methods.cocoop import CoCoOp
    from rpo_tpu_torch.methods.linear_probe import LP

    if isinstance(evaluator, CoCoOp):
        cocoop_checks(label, evaluator, evaluator.clip_params, [images], [logits])
        return
    plain = plain_eval_logits(evaluator, images)
    atol = SLICE_ATOL
    if isinstance(evaluator, LP):
        atol = (plain.float() - lp_witness_logits(evaluator, images)).abs().max().item()
        label = f"{label} (bound: both plain versions' max_abs_err from an f32 witness)"
    check_logits(label, [logits], [plain], SINGLE_PAIR_ARGMAX_AGREE,
                 against="both plain versions", atol=atol)
    if isinstance(evaluator, LP):
        for lost, fault in PLANTED_FAULTS:
            err = (logits.float() - plain_eval_logits(evaluator, images, fault).float()).abs()
            caught = err.max().item() > atol
            print(f"{label}: against the plain path with {lost} lost from every rect attention (a "
                  f"planted fault): max_abs_err {err.max().item():.3e} (bound {atol:.4g}) "
                  f"{'caught' if caught else 'NOT caught'}", flush=True)
            if not caught:
                fail(f"{label}: the logits' bound does not catch a planted fault")


def baseline_eval_only(out: str, label: str, argv, expect: dict, accuracy=None,
                       model_dir: str = ""):
    """An eval-only CLI run of ``argv`` (of ``model_dir``'s last checkpoint
    where one is given, with the same accuracy as ``accuracy``): the
    launches of its test batches and text set-up against ``expect``; the
    last test batch's logits against both plain versions.  Returns the
    evaluating trainer, its launches (rect, masked, fused text), its
    accuracy."""
    from rpo_tpu_torch.ops import fused_text_layer as ftl
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    ra.launches = ma.launches = ftl.launches = 0
    i = argv.index("--output-dir")
    load = ["--model-dir", model_dir, "--load-epoch", str(RUN_EPOCHS)] if model_dir else []
    evaluator, log = run_cli(argv[:i] + ["--output-dir", out, "--eval-only", *load] + argv[i + 2:])
    torch.cuda.synchronize()
    launches = (ra.launches, ma.launches, ftl.launches)
    n_eval = len(evaluator.dm.test_loader)
    (rect_eval, fused_eval) = expect["eval"]
    want = (rect_eval * n_eval, expect["setup_masked"], fused_eval * n_eval)
    found = re.findall(r"\* accuracy: ([\d.]+)%", log)
    ok = len(found) == 1 and (accuracy is None or found == accuracy) and launches == want and \
        "Finish training" not in log and "=> result" in log
    loaded = f" (--load-epoch {RUN_EPOCHS})" if model_dir else ""
    against = "" if accuracy is None else f" against the final test's {accuracy}"
    print(f"{label} eval-only{loaded}: accuracy {found}{against}; launches (rect, masked, fused "
          f"text) {launches} = {want} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}: the eval-only run's accuracy, launches or log are not as expected")
    batch = [b for b in evaluator.dm.test_loader][-1]
    logits = evaluator.eval_step(batch["img"])
    check_run_logits(f"{label} last test batch ({batch['n']} images)", evaluator, batch["img"],
                     logits)
    return evaluator, launches, found


def baseline_plain_epoch(label: str, evaluator, step_losses) -> None:
    """Epoch 1 again, eagerly on both plain versions: the same seed, so the
    same few-shot draw, batches and first trainable tensors, the warm-up LR;
    its losses against the run's within TRAIN_LOSS_ATOL.  CoCoOp at batch
    16 first holds its accumulated step to the monolithic one on the first
    batch (both on the kernels).  LP's first PLANTED_STEPS steps run first
    on the plain path with each of PLANTED_FAULTS, from the same state: the
    bound must fail the last (the first moves LP's logits by less than
    bf16 rounding moves the plain path: its reading is printed)."""
    from rpo_tpu_torch.cli import set_random_seed
    from rpo_tpu_torch.engine import build_trainer
    from rpo_tpu_torch.engine.optim import lr_at_epoch
    from rpo_tpu_torch.methods.cocoop import ACCUM_BATCH, CoCoOp
    from rpo_tpu_torch.methods.linear_probe import LP, lp_text_features
    from rpo_tpu_torch.methods.step_graph import state_kept
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    set_random_seed(1)
    plain = build_trainer(evaluator.cfg.clone(), clip_params=evaluator.clip_params,
                          device=evaluator.device)
    batches = list(plain.dm.train_loader_x)
    if isinstance(plain, CoCoOp) and int(plain.cfg.DATALOADER.TRAIN_X.BATCH_SIZE) >= ACCUM_BATCH:
        b = batches[0]
        args = (plain._train_images(b), b["label"], b["mask"])
        loss, logits, grads = plain.loss_and_grads_of("accumulated", *args)
        m_loss, m_logits, m_grads = plain.loss_and_grads_of("monolithic", *args)
        loss_err = abs(loss.item() - m_loss.item())
        logits_err = (logits - m_logits).abs().max().item()
        print(f"{label} first step, accumulated (chunks of 8) against monolithic on the same "
              f"batch of {len(b['label'])}: loss {loss.item():.6f} vs {m_loss.item():.6f} (err "
              f"{loss_err:.3e}, tol {TRAIN_LOSS_ATOL:g}); logits max_abs_err {logits_err:.3e} (tol "
              f"{SLICE_ATOL})", flush=True)
        failed = grads_close(f"{label} first step's gradients, accumulated against monolithic",
                             grads, m_grads)
        if failed or loss_err > TRAIN_LOSS_ATOL or logits_err > SLICE_ATOL:
            fail(f"{label}: the accumulated step disagrees with the monolithic one")
    if isinstance(plain, LP):
        plain._frozen["text_f"] = lp_text_features(
            plain.clip_params, plain.clip_cfg, plain.classnames, plain.prompt,
            ma.masked_attention_reference)
    lr = lr_at_epoch(plain.cfg.OPTIM, 0)

    def losses(steps, rect):
        return torch.stack([plain.train_step(
            plain._train_images(b), b["label"], b["mask"], lr, rect_attn=rect,
            masked_attn=ma.masked_attention_reference)[0] for b in steps]).float().cpu()

    for i, (lost, fault) in enumerate(PLANTED_FAULTS if isinstance(plain, LP) else ()):
        with state_kept([t for t in plain._graph_bound() if isinstance(t, torch.Tensor)]):
            planted = losses(batches[:PLANTED_STEPS], fault)
        err = (step_losses[:PLANTED_STEPS] - planted).abs().max().item()
        caught = err > TRAIN_LOSS_ATOL
        print(f"{label} epoch 1's first {PLANTED_STEPS} steps vs the same on the plain path with "
              f"{lost} lost from every rect attention (a planted fault): max_abs_err {err:.3e} "
              f"(tol {TRAIN_LOSS_ATOL:g}) {'caught' if caught else 'NOT caught'}", flush=True)
        if not caught and i == len(PLANTED_FAULTS) - 1:
            fail(f"{label}: the losses' bound does not catch a planted fault")
    p_losses = losses(batches, ra.rect_attention_reference)
    n = len(batches)
    err = (step_losses[:n] - p_losses).abs().max().item()
    ok = err <= TRAIN_LOSS_ATOL
    print(f"{label} epoch 1 ({n} steps at LR {lr:g}) vs the same epoch on both plain versions, "
          f"eagerly: max_abs_err {err:.3e} (tol {TRAIN_LOSS_ATOL:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{label}: epoch 1's losses disagree with the plain run")


def baseline_runs(out: str, smi: str, n_layers: int, text_layers: int) -> dict:
    """Phase 13: every ViT-B/16 baseline of the paper through the CLI, as in
    phase 11 (the engine, each step a replay of a captured graph, the
    checkpoint, the final test, an eval-only reload), with its own checks:
    the replay against the eager step, the attention backward's share of
    an eager step, epoch 1 against both plain versions, and for CoCoOp at
    batch 16 the accumulated step against the monolithic one; then
    ZeroshotCLIP and ZeroshotCLIP2 evaluate with --eval-only.  Returns the
    launches by kernel and path, the replayed ones and the rates."""
    from rpo_tpu_torch.engine.config import get_cfg_default
    from rpo_tpu_torch.ops import fused_text_layer as ftl
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    launches = {"rect": {}, "masked": {}, "fused": {}, "rect_replayed": {},
                "masked_replayed": {}}
    rates = {}
    for label, trainer_name, config, shots, extra in BASELINES:
        sub = os.path.join(out, label.replace(", ", "_").replace(" ", "_"))
        argv = baseline_argv(os.path.join(sub, "train"), trainer_name, config, [
            "DATASET.NUM_SHOTS", str(shots), "OPTIM.MAX_EPOCH", str(RUN_EPOCHS), *extra])
        opts = dict(zip(extra[::2], extra[1::2]))
        cfg = get_cfg_default()
        cfg.merge_from_file(argv[argv.index("--config-file") + 1])
        batch = int(opts.get("DATALOADER.TRAIN_X.BATCH_SIZE", cfg.DATALOADER.TRAIN_X.BATCH_SIZE))
        expect = baseline_expect(trainer_name, batch, int(cfg.DATALOADER.TEST.BATCH_SIZE),
                                 n_layers, text_layers)
        trainer, log, losses, rate, accuracy, made, replayed, first = cli_train(argv, smi, label,
                                                                                expect)
        launches["rect"][label], launches["masked"][label] = ra.launches, ma.launches
        launches["fused"][label] = ftl.launches
        launches["rect_replayed"][label] = replayed["rect"]
        launches["masked_replayed"][label] = replayed["masked"]
        rates[label] = rate
        replay_equals_eager(label, trainer, first)
        profile_backward_share(label, trainer, made[0], smi)
        output_dir = trainer.output_dir
        del trainer
        evaluator, counts, _ = baseline_eval_only(os.path.join(sub, "eval"), label, argv, expect,
                                                  accuracy, output_dir)
        launches["rect"][f"{label}, eval-only"], launches["masked"][f"{label}, eval-only"], \
            launches["fused"][f"{label}, eval-only"] = counts
        baseline_plain_epoch(label, evaluator, losses)
        del evaluator
    for label in ("ZeroshotCLIP", "ZeroshotCLIP2"):
        trainer_name = label
        argv = baseline_argv(os.path.join(out, trainer_name), trainer_name, ZERO_SHOT_CONFIG,
                             ["DATASET.SUBSAMPLE_CLASSES", "new"])
        n_templates = 8 if trainer_name == "ZeroshotCLIP2" else 1
        expect = {"eval": (n_layers, 0), "setup_masked": text_layers * n_templates}
        evaluator, counts, found = baseline_eval_only(
            os.path.join(out, trainer_name), label, argv, expect)
        if os.listdir(os.path.join(out, trainer_name)) != ["log.txt"]:
            fail(f"{label} wrote more than its log: {os.listdir(os.path.join(out, trainer_name))}")
        launches["rect"][f"{label}, eval-only"], launches["masked"][f"{label}, eval-only"], \
            launches["fused"][f"{label}, eval-only"] = counts
        print(f"{label} eval-only (CLI, {ZERO_SHOT_CONFIG}, Synthetic's {len(evaluator.dm.classnames)} new "
              f"classes, {n_templates} template(s)): accuracy {found}, nothing trained or saved",
              flush=True)
        del evaluator
    print(f"baselines on {smi}, train images/s over epoch 2: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    return {"launches": launches, "rates": rates}


# Phase 14: (backbone, resolution, eval batches of 100) of ZeroshotCLIP in process
RN_EVALS = (("RN50", 224, N_BATCHES), ("RN101", 224, N_BATCHES), ("RN50x4", 288, 1),
            ("RN50x16", 384, 1))
RN_WITNESS_COS = 0.99  # bf16 image features against an f32 witness, per image
RN_COOP_CONFIG = "configs/trainers/CoOp/rn50_ep50.yaml"
RN_ZERO_SHOT = (("ZeroshotCLIP RN101", "ZeroshotCLIP", "configs/trainers/CoOp/rn101.yaml", False),
                ("ZeroshotCLIP2 RN50 from a checkpoint", "ZeroshotCLIP2",
                 "configs/trainers/CoOp/rn50.yaml", True))


def random_openai_state_dict(cfg, seed: int, dtype=np.float16) -> dict:
    """A random CLIP state dict in OpenAI's layout and dtype (fp16), made
    with numpy: weights ~ N(0, 1/fan_in), embeddings ~ N(0, 0.02),
    LayerNorm and BN scales ~ 1 +- 0.2, biases and BN means ~ 0 +- 0.1,
    BN variances in [0.5, 2), and OpenAI's three integer entries."""
    from rpo_tpu_torch.models.clip.convert import state_dict_shapes

    rng = np.random.RandomState(seed)
    sd = {}
    for key, shape in state_dict_shapes(cfg).items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(0)
            continue
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif key == "logit_scale":
            a = np.array(np.log(1 / 0.07))
        elif key.endswith(("bias", "running_mean")):
            a = 0.1 * rng.randn(*shape)
        elif len(shape) == 1:
            a = 1 + 0.2 * rng.randn(*shape)
        elif "embedding" in key:
            a = 0.02 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) / math.sqrt(int(np.prod(shape[1:])))
        sd[key] = torch.from_numpy(a.astype(dtype))
    for key, value in (("input_resolution", cfg.image_resolution),
                       ("context_length", cfg.context_length), ("vocab_size", cfg.vocab_size)):
        sd[key] = torch.tensor(value)
    return sd


def tree_pairs(a, b, path=""):
    """(path, a's leaf, b's leaf) over two trees of dicts and lists, which
    must have the same structure."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            fail(f"tree structure differs at {path or 'the root'}")
        for k in b:
            yield from tree_pairs(a[k], b[k], f"{path}.{k}" if path else k)
    elif isinstance(b, list):
        if not isinstance(a, list) or len(a) != len(b):
            fail(f"tree structure differs at {path}")
        for i, (x, y) in enumerate(zip(a, b)):
            yield from tree_pairs(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


def rn_eval(name: str, size: int, n_batches: int, classnames, smi: str, profile: bool,
            device: str = "cuda"):
    """ZeroshotCLIP (Caltech101's template) on a random seed-1 ``name`` in
    bf16 over ``n_batches`` batches of 100 uint8 ``size`` x ``size`` images:
    12 masked launches for the text features and no rect one; the logits
    against the same path with the plain masked attention (5e-2, argmax
    97%); each image's features against an f32 witness of the same weights
    (cosine >= RN_WITNESS_COS); images/s after one warm-up batch (which a
    rate of one batch would otherwise hold); with ``profile``, one more batch
    under torch.profiler with the attention pool in a labelled range.
    Returns (the set-up's masked launches, images/s at the median batch).
    ``device`` is the card, or the CPU for a rehearsal at a test size."""
    from rpo_tpu_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, \
        device_normalize_fn
    from rpo_tpu_torch.methods import zsclip
    from rpo_tpu_torch.models.clip import resnet as rn
    from rpo_tpu_torch.models.clip.model import ARCHS, encode_image, init_clip
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    cfg = ARCHS[name]
    if cfg.image_resolution != size:
        fail(f"{name}: resolution {cfg.image_resolution}, expected {size}")
    rng = np.random.RandomState(14)
    batches = [rng.randint(0, 256, (EVAL_BATCH, size, size, 3)).astype(np.uint8)
               for _ in range(n_batches)]
    clip32 = init_clip(torch.Generator(device=device).manual_seed(1), cfg)
    ra.launches = ma.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs = zsclip.ZeroshotCLIP(classnames, "Caltech101", backbone=name, seed=1, device=device,
                             clip_params=clip32)
    zs.text_features()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup = check_launches(f"ZeroshotCLIP {name} set-up", ma, cfg.text_layers)
    zs.eval_step(batches[0])  # warm-up: cuDNN's first call at a shape picks its kernels
    torch.cuda.synchronize()
    logits, batch_s = run_batches(zs.eval_step, batches)
    check_launches(f"ZeroshotCLIP {name} eval", ra, 0)
    check_launches(f"ZeroshotCLIP {name} eval", ma, cfg.text_layers)
    plain = [plain_eval_logits(zs, images) for images in batches]
    check_logits(f"slice ZeroshotCLIP {name} bf16 {size}x{size} n_cls={len(classnames)}", logits,
                 plain, SINGLE_PAIR_ARGMAX_AGREE, against="the plain masked attention")
    witness = {**clip32, "visual": rn.conv_layout(clip32["visual"])}
    normalize32 = device_normalize_fn(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, dtype=torch.float32)
    cos, err, big = [], 0.0, 0.0
    with torch.no_grad():
        for images in batches:
            x = torch.from_numpy(images).to(device)
            got = encode_image(zs.clip_params, cfg, zs._normalize(x)).float()
            want = encode_image(witness, cfg, normalize32(x))
            cos.append(F.cosine_similarity(got.double(), want.double(), dim=-1))
            err = max(err, (got - want).abs().max().item())
            big = max(big, want.abs().max().item())
    cos = torch.cat(cos)
    ok = cos.min().item() >= RN_WITNESS_COS and bool(torch.isfinite(cos).all())
    print(f"ZeroshotCLIP {name} image features (bf16) against an f32 witness of the same weights "
          f"(TF32 off), {cos.numel()} images: cosine min {cos.min().item():.6f}, median "
          f"{cos.median().item():.6f} (>= {RN_WITNESS_COS}); max_abs_err {err:.3e} of max "
          f"|feature| {big:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"ZeroshotCLIP {name}: image features disagree with the f32 witness")
    rate = report_rate(f"ZeroshotCLIP {name} ({size}x{size})", setup_s, batch_s, smi)
    if profile:
        pool = rn.attention_pool

        def labelled(*args):
            with torch.profiler.record_function("attention pool"):
                return pool(*args)

        rn.attention_pool = labelled
        try:
            profile_eval_step(zs.eval_step, batches[-1], smi, f"ZeroshotCLIP {name}",
                              ranges=("attention pool",))
        finally:
            rn.attention_pool = pool
    return setup, rate


def resnet_runs(out: str, smi: str, classnames, device: str = "cuda") -> dict:
    """Phase 14: the ModifiedResNet towers.  ZeroshotCLIP in process on
    RN50, RN101 (three batches each), RN50x4 and RN50x16 (one); CoOp's
    rn50_ep50 through the CLI as phase 13's CoOp run (the replay against
    the eager step, an eval-only reload, epoch 1 against the plain
    versions); ZeroshotCLIP --eval-only on RN101 and ZeroshotCLIP2 on RN50
    loaded from a random OpenAI-layout fp16 checkpoint, whose tree must
    equal ``convert_state_dict``'s of the same dict.  Returns the masked
    launches and replays by path and the rates.  ``device`` as in
    ``rn_eval``."""
    from rpo_tpu_torch.models.clip.convert import convert_state_dict
    from rpo_tpu_torch.models.clip.model import ARCHS, cast_params
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra

    if torch.backends.cudnn.benchmark:
        fail("cuDNN benchmark mode is on: a capture may pick other algorithms than the eager step")
    masked, replayed, rates = {}, {}, {}
    for name, size, n_batches in RN_EVALS:
        setup, rates[f"ZeroshotCLIP {name}"] = rn_eval(name, size, n_batches, classnames, smi,
                                                       n_batches > 1, device)
        masked[f"ZeroshotCLIP {name} set-up"] = setup
    rn50 = ARCHS[RN_EVALS[0][0]]
    text_layers = rn50.text_layers

    label = "CoOp RN50 run"
    sub = os.path.join(out, "coop_rn50")
    argv = baseline_argv(os.path.join(sub, "train"), "CoOp", RN_COOP_CONFIG, [
        "DATASET.NUM_SHOTS", str(RUN_SHOTS), "OPTIM.MAX_EPOCH", str(RUN_EPOCHS)])
    expect = {"model": "prompt_learner", "step": (0, text_layers), "eval": (0, 0),
              "setup_masked": text_layers}
    trainer, log, losses, rate, accuracy, made, graph_replayed, first = cli_train(
        argv, smi, label, expect)
    masked[label], replayed[label], rates[label] = ma.launches, graph_replayed["masked"], rate
    if ra.launches:
        fail(f"{label} launched the rect kernel {ra.launches} times")
    replay_equals_eager(label, trainer, first)
    profile_backward_share(label, trainer, made[0], smi)
    output_dir = trainer.output_dir
    del trainer
    evaluator, counts, _ = baseline_eval_only(os.path.join(sub, "eval"), label, argv, expect,
                                              accuracy, output_dir)
    masked[f"{label}, eval-only"] = counts[1]
    baseline_plain_epoch(label, evaluator, losses)
    del evaluator

    for label, trainer_name, config, from_checkpoint in RN_ZERO_SHOT:
        sub = os.path.join(out, trainer_name + ("_ckpt" if from_checkpoint else ""))
        os.makedirs(sub)
        argv = baseline_argv(os.path.join(sub, "run"), trainer_name, config,
                             ["DATASET.SUBSAMPLE_CLASSES", "new"])
        n_templates = 8 if trainer_name == "ZeroshotCLIP2" else 1
        expect = {"eval": (0, 0), "setup_masked": text_layers * n_templates}
        sd, path = None, os.path.join(sub, "RN50.pt")
        if from_checkpoint:
            sd = random_openai_state_dict(rn50, seed=1)
            torch.save(sd, path)
            os.environ["CLIP_CHECKPOINT"] = path
        try:
            evaluator, counts, found = baseline_eval_only(os.path.join(sub, "run"), label, argv,
                                                          expect)
        finally:
            os.environ.pop("CLIP_CHECKPOINT", None)
        masked[f"{label}, eval-only"] = counts[1]
        with open(os.path.join(sub, "run", "log.txt")) as f:
            run_log = f.read()
        if from_checkpoint:
            want = cast_params(convert_state_dict(sd, device=device), torch.bfloat16)
            pairs = list(tree_pairs(evaluator.clip_params, want))
            differ = [p for p, a, b in pairs if a.dtype != b.dtype or not torch.equal(a, b)]
            ok = not differ and evaluator.clip_cfg == rn50 and \
                f"Loading CLIP (backbone: RN50) from {path}" in run_log
            print(f"{label}: the CLI's tree against convert_state_dict of the same fp16 state dict "
                  f"(cast to bf16): {len(pairs)} leaves, {len(differ)} differ {differ[:3]}; config "
                  f"inferred = RN50's {evaluator.clip_cfg == rn50}; loaded from "
                  f"$CLIP_CHECKPOINT {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{label}: the loaded backbone is not the checkpoint's")
        elif "RANDOM weights" not in run_log:
            fail(f"{label}: expected the seed-1 random backbone")
        print(f"{label} eval-only (CLI, {config}, Synthetic's {len(evaluator.dm.classnames)} new "
              f"classes, {n_templates} template(s)): accuracy {found}", flush=True)
        del evaluator
    print(f"ResNet on {smi}: " + ", ".join(f"{k} {v:.1f} images/s" for k, v in rates.items()),
          flush=True)
    return {"masked": masked, "masked_replayed": replayed, "rates": rates}


# Phase 15: the paper's file-backed datasets, on trees whose image files are
# copies of the committed JPEG fixtures (the machine with the card may have
# no JPEG encoder).  Every reader under these NUM_SHOTS and SUBSAMPLE_CLASSES:
READER_SHOTS = (-1, 16)
READER_SUBSAMPLES = ("all", "base", "new")
FIXTURE_DIR = os.path.join("tests", "torch_port_data")
# what the readers write into a tree (split JSON, few-shot cache, ImageNet's items)
READER_FILES = ("split_zhou_*.json", "split_fewshot", "preprocessed*.pkl")
# the CLI runs: RPO on a Caltech101 tree of 10 classes x 40 JPEGs (16 shots
# of the 5 base classes: 20 steps an epoch at batch 4), zero-shot on an
# ImageNet tree of 10 wnids with 10 val images each
FILE_RUN_CLASSES, FILE_RUN_PER_CLASS = 10, 40
IMAGENET_WNIDS, IMAGENET_TRAIN, IMAGENET_VAL = 10, 4, 10
CALTECH_CONFIG, IMAGENET_CONFIG = "configs/datasets/caltech101.yaml", \
    "configs/datasets/imagenet.yaml"


def decoder_probe() -> dict:
    """Phase 15 (a): what this machine has to read a JPEG file with, found
    before anything reads one: Pillow, g++, and the port's native library
    (built here from ``rpo_tpu_torch/_native``, as the loader would)."""
    from rpo_tpu_torch import _native

    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = None
    gxx = shutil.which("g++")
    t0 = time.perf_counter()
    lib = _native.get_lib()
    build_s = time.perf_counter() - t0
    why = next((ln.strip() for ln in _native.build_log.splitlines() if "error" in ln),
               _native.build_log.strip()[:200] or "RPO_TPU_NO_NATIVE=1")
    native = "builds and loads" if lib is not None else f"unavailable ({why})"
    decoder = "the native library" if lib is not None else (
        f"Pillow {pillow}" if pillow else None)
    print(f"file datasets probe: Pillow {pillow or 'not importable'} | g++ {gxx or 'absent'} | "
          f"native library {native} ({build_s:.1f} s) | JPEG decoder: "
          f"{decoder or 'none'}", flush=True)
    return {"pillow": pillow, "gxx": gxx, "native": lib is not None, "why": why,
            "decoder": decoder}


def reader_files(root: str) -> list:
    return [p for pattern in READER_FILES for p in glob.glob(os.path.join(root, "*", pattern))]


def reader_checks(root: str, sources) -> None:
    """Phase 15 (b): every file-backed reader on its tree, under each of
    READER_SHOTS and READER_SUBSAMPLES from a tree without the files the
    readers write: train_x, val and test counts and the classnames equal
    what the tree defines (``fake_datasets.expected``), every item's file
    exists, the few-shot cache is written where shots are drawn, and a
    second build under another random state gives the same items (the
    split file and the cache read back).  Pure Python: no image is read."""
    import random

    from rpo_tpu_torch.engine.config import get_cfg_default
    from rpo_tpu_torch.engine.registry import DATASET_REGISTRY
    from rpo_tpu_torch.tools import fake_datasets

    def build(name, tree, shots, subsample, seed):
        cfg = get_cfg_default()
        cfg.DATASET.ROOT, cfg.DATASET.NAME, cfg.SEED = tree, name, 1
        cfg.DATASET.NUM_SHOTS, cfg.DATASET.SUBSAMPLE_CLASSES = shots, subsample
        random.seed(seed)
        ds = DATASET_REGISTRY.get(name)(cfg)
        return ds, {s: [(d.impath, d.label, d.classname) for d in getattr(ds, s)]
                    for s in ("train_x", "val", "test")}

    t0 = time.perf_counter()
    for name in sorted(fake_datasets.WRITERS):
        tree = os.path.join(root, name)
        layout = fake_datasets.write_tree(name, tree, sources)
        seen = []
        for shots in READER_SHOTS:
            for subsample in READER_SUBSAMPLES:
                for path in reader_files(tree):
                    shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
                ds, items = build(name, tree, shots, subsample, 1)
                want = fake_datasets.expected(layout, shots, subsample)
                got = {s: len(v) for s, v in items.items()}
                cache = os.path.join(ds.dataset_dir, "split_fewshot", f"shot_{shots}-seed_1.pkl")
                _, again = build(name, tree, shots, subsample, 2)
                ok = got == {s: want[s] for s in got} and ds.classnames == want["classnames"] \
                    and all(os.path.isfile(p) for v in items.values() for p, _, _ in v) \
                    and (shots < 1 or layout.test_only or os.path.exists(cache)) \
                    and again == items
                if not ok:
                    fail(f"reader {name} (NUM_SHOTS {shots}, {subsample}): train_x, val, test "
                         f"{got} against the tree's {want}, classnames {ds.classnames}, few-shot "
                         f"cache {os.path.exists(cache)}, the second build equal {again == items}")
                seen.append(f"{shots}/{subsample} {got['train_x']}/{got['val']}/{got['test']}")
        print(f"reader {name}: {len(layout.classnames)} classes, {layout.files} files; (NUM_SHOTS/"
              f"SUBSAMPLE train_x/val/test) {'; '.join(seen)}; classnames, files, few-shot cache "
              f"and a second build ok", flush=True)
    print(f"readers: {len(fake_datasets.WRITERS)} datasets x {len(READER_SHOTS)} NUM_SHOTS x "
          f"{len(READER_SUBSAMPLES)} SUBSAMPLE_CLASSES in {time.perf_counter() - t0:.1f} s",
          flush=True)


class BatchRoutes:
    """Counts, during a CLI run, the batches the loader made through the
    native library's batch entry points and those it made otherwise."""

    def __init__(self):
        from rpo_tpu_torch.data.loader import BatchLoader

        self.cls, self.counts = BatchLoader, {"native": 0, "python": 0}
        self.saved = {n: getattr(BatchLoader, n) for n in
                      ("_native_train_batch", "_native_fixed_batch", "_make_batch")}

    def __enter__(self):
        counts, saved = self.counts, self.saved

        def native(name):
            def call(loader, *args):
                imgs = saved[name](loader, *args)
                loader._native_served = imgs is not None
                return imgs
            return call

        def make(loader, *args, **kw):
            loader._native_served = False
            batch = saved["_make_batch"](loader, *args, **kw)
            counts["native" if loader._native_served else "python"] += 1
            return batch

        for name in ("_native_train_batch", "_native_fixed_batch"):
            setattr(self.cls, name, native(name))
        self.cls._make_batch = make
        return self.counts

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)


def file_argv(out: str, trainer: str, dataset: str, config: str, root: str, extra=()) -> list:
    here = os.path.dirname(os.path.abspath(__file__))
    return ["--seed", "1", "--trainer", trainer,
            "--dataset-config-file", os.path.join(here, dataset),
            "--config-file", os.path.join(here, config), "--output-dir", out,
            "DATASET.ROOT", root, *extra]


def file_dataset_runs(out: str, smi: str, probe: dict, sources, phase11: dict, n_layers: int,
                      text_layers: int) -> dict:
    """Phase 15 (c): with a JPEG decoder, the CLI on file trees.  RPO
    main_K24 on a Caltech101 tree (FILE_RUN_CLASSES x FILE_RUN_PER_CLASS of
    the fixtures, mixed sizes; 16 shots of the base classes, RUN_EPOCHS
    epochs at batch 4, then the test split), as phase 11 checks it (the
    launches, the log contract, finite losses, an eval-only reload whose
    last test batch's logits hold to both plain versions); the same on a
    tree of the 224 x 224 fixtures with INPUT.DEVICE_RESIZE 224 (the
    exact-size sources: the native batch decode where it exists, the
    device augmentation against the host's as phase 12); then
    ZeroshotCLIP2 --eval-only on an ImageNet tree (classnames.txt,
    preprocessed.pkl, ImageNet's 7 templates).  Each run's engine means and
    images/s beside phase 11's, and the batches the native library made.
    Without a decoder, one line says so.  Returns the launches by path."""
    from rpo_tpu_torch.methods.templates import IMAGENET_TEMPLATES_SELECT
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra
    from rpo_tpu_torch.tools import fake_datasets

    launches = {"rect": {}, "masked": {}, "rect_replayed": {}}
    if probe["decoder"] is None:
        print(f"file datasets, CLI runs: not run, this machine has no JPEG decoder (Pillow not "
              f"importable; the native library: {probe['why']}); on the CPU "
              f"tests/test_torch_port_native.py::test_cli_on_a_caltech101_tree_equals_jax holds "
              f"this path against the JAX package's", flush=True)
        return launches
    caltech = os.path.join(out, "caltech")
    fake_datasets.write_tree("Caltech101", caltech, sources, n_classes=FILE_RUN_CLASSES,
                             per_class=FILE_RUN_PER_CLASS)
    caltech_224 = os.path.join(out, "caltech_224")
    fake_datasets.write_tree("Caltech101", caltech_224, [p for p in sources if "224x224" in p],
                             n_classes=FILE_RUN_CLASSES, per_class=FILE_RUN_PER_CLASS)
    shots = ["DATASET.NUM_SHOTS", str(RUN_SHOTS), "DATASET.SUBSAMPLE_CLASSES", "base",
             "OPTIM.MAX_EPOCH", str(RUN_EPOCHS)]
    runs = (("RPO Caltech101 run", caltech, []),
            ("RPO Caltech101 run, DEVICE_RESIZE 224", caltech_224,
             ["INPUT.DEVICE_RESIZE", "224"]))
    for label, root, extra in runs:
        sub = os.path.join(out, label.replace(", ", "_").replace(" ", "_"))
        argv = file_argv(os.path.join(sub, "train"), "RPO", CALTECH_CONFIG,
                         "configs/trainers/RPO/main_K24.yaml", root, shots + extra)
        with BatchRoutes() as routes:
            trainer, log, losses, rate, accuracy, made, replayed, _ = cli_train(
                argv, smi, label, rpo_expect(n_layers, text_layers))
        launches["rect"][label], launches["masked"][label] = ra.launches, ma.launches
        launches["rect_replayed"][label] = replayed["rect"]
        means = re.findall(r"epoch \[(\d)/\d\] batch \[(\d+)/(\d+)\] time [\d.]+ \(([\d.]+)\) "
                           r"data [\d.]+ \(([\d.]+)\)", log)
        means = [(e, step, data) for e, b, nb, step, data in means if b == nb]
        print(f"{label} on {smi}: decoder {probe['decoder']}; loader batches made by the native "
              f"library {routes['native']}, otherwise {routes['python']}; engine means (epoch, "
              f"step s, data s) {means}; {rate:.1f} train images/s over epoch 2 against phase "
              f"11's {phase11['rate']:.1f} on Synthetic", flush=True)
        if probe["native"] and routes["native"] == 0:
            fail(f"{label}: the native library loaded, and the loader made no batch with it")
        if extra:
            device_resize_check(label, trainer, made)
        evaluator, (rect, masked) = eval_only_check(sub, label, trainer, argv, accuracy,
                                                    n_layers, text_layers)
        launches["rect"][f"{label}, eval-only"] = rect
        launches["masked"][f"{label}, eval-only"] = masked
        del trainer, evaluator

    imagenet = os.path.join(out, "imagenet")
    layout = fake_datasets.write_tree("ImageNet", imagenet, sources, n_classes=IMAGENET_WNIDS,
                                      train=IMAGENET_TRAIN, val=IMAGENET_VAL)
    label = "ZeroshotCLIP2 ImageNet"
    n_templates = len(IMAGENET_TEMPLATES_SELECT)  # ImageNet's ensemble has no custom template
    argv = file_argv(os.path.join(out, "zs_imagenet"), "ZeroshotCLIP2", IMAGENET_CONFIG,
                     ZERO_SHOT_CONFIG, imagenet)
    with BatchRoutes() as routes:
        evaluator, counts, found = baseline_eval_only(
            os.path.join(out, "zs_imagenet"), label, argv,
            {"eval": (n_layers, 0), "setup_masked": text_layers * n_templates})
    cache = os.path.join(imagenet, "imagenet", "preprocessed.pkl")
    ok = evaluator.dm.classnames == layout.classnames and os.path.exists(cache) and \
        len(evaluator.templates) == n_templates and \
        len(evaluator.dm.dataset.test) == IMAGENET_WNIDS * IMAGENET_VAL
    print(f"{label} eval-only (CLI, {ZERO_SHOT_CONFIG}, {len(evaluator.dm.classnames)} wnids, "
          f"{len(evaluator.dm.dataset.test)} val images, {n_templates} templates): accuracy "
          f"{found}; classnames in sorted-wnid order from classnames.txt, preprocessed.pkl "
          f"written {os.path.exists(cache)}; loader batches made by the native library "
          f"{routes['native']}, otherwise {routes['python']} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{label}: the classnames, the item cache or the templates are not ImageNet's")
    launches["rect"][f"{label}, eval-only"], launches["masked"][f"{label}, eval-only"] = \
        counts[:2]
    del evaluator
    return launches


def file_datasets(out: str, smi: str, phase11: dict, n_layers: int, text_layers: int) -> dict:
    """Phase 15: the probe (a), the readers (b), the CLI runs (c)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sources = sorted(glob.glob(os.path.join(here, FIXTURE_DIR, "*.jpg")))
    if len(sources) != 8:
        fail(f"phase 15 needs the 8 JPEG fixtures under {FIXTURE_DIR}; found {len(sources)}")
    probe = decoder_probe()
    reader_checks(os.path.join(out, "readers"), [p for p in sources if "64x64" in p])
    return file_dataset_runs(os.path.join(out, "runs"), smi, probe, sources, phase11, n_layers,
                             text_layers)


def run_tool(main_fn, argv) -> tuple:
    """A tool's ``main(argv)`` in this process: (its exit code, its
    standard output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


def tools_phase(run_dir: str, smi: str, selftest_total: int) -> None:
    """Phase 16: the package's tools on the card.  (a) The kernel-selftest
    CLI as a subprocess: exit 0, every check passing, as many as phase 3
    ran.  (b) ``profile_step`` for train (graph replays) and eval, 5 steps
    each: its device operations by group and the idle share.  (c) Phase
    11's checkpoint exported to the reference's torch format and read back
    by the port's loader, equal to the checkpoint.  (d)
    ``bench_device_preprocess`` for eval and train at a few iterations:
    its JSON line."""
    from rpo_tpu_torch.engine.trainer import _load_checkpoint_file
    from rpo_tpu_torch.tools import bench_device_preprocess, export_torch_ckpt, profile_step

    here = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rpo_tpu_torch.tools.kernel_selftest", "--quiet"],
                          cwd=here, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
    ok = proc.returncode == 0 and out.get("value") == out.get("total") == selftest_total
    print(f"tools: python -m rpo_tpu_torch.tools.kernel_selftest: exit {proc.returncode}, "
          f"{out.get('value')} of {out.get('total')} checks pass (phase 3 ran {selftest_total}), "
          f"backend {out.get('backend')}, device {out.get('device')}, nvidia-smi "
          f"{out.get('nvidia_smi')}, checks {out.get('seconds')} s, build "
          f"{out.get('build_seconds')} s, the process {time.perf_counter() - t:.1f} s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        print(proc.stderr[-4000:], flush=True)
        fail("the kernel-selftest CLI did not pass every check of phase 3's table")

    for what in ("train", "eval"):
        t = time.perf_counter()
        rc, text = run_tool(profile_step.main, ["--phase", what, "--steps", "5", "--top", "8"])
        shown = text[text.index("by group:"):] if "by group:" in text else text
        secs = time.perf_counter() - t
        print(f"tools: profile_step --phase {what} --steps 5 on {smi}, {secs:.1f} s, exit {rc}:\n"
              + "\n".join(f"  {ln}" for ln in shown.strip().splitlines()), flush=True)
        if rc != 0 or "window:" not in text:
            fail(f"profile_step --phase {what} failed (exit {rc})")

    ckpt = os.path.join(run_dir, "train", "prompt_learner", f"model.pth.tar-{RUN_EPOCHS}")
    exported = os.path.join(run_dir, "exported.pth.tar")
    method = export_torch_ckpt.export(ckpt, exported)
    src, back = _load_checkpoint_file(ckpt), _load_checkpoint_file(exported)
    payload = torch.load(exported, map_location="cpu", weights_only=False)
    same = (method == "rpo" and set(back["state_dict"]) == set(src["state_dict"])
            and all(np.array_equal(back["state_dict"][k], np.asarray(v))
                    for k, v in src["state_dict"].items())
            and all(isinstance(v, torch.Tensor) for v in payload["state_dict"].values())
            and payload["epoch"] == src["epoch"] == RUN_EPOCHS)
    print(f"tools: export_torch_ckpt of phase 11's {os.path.basename(ckpt)}: method {method}, "
          f"keys {sorted(payload['state_dict'])}, epoch {payload['epoch']}, read back by the "
          f"port's loader equal to the checkpoint: {same} {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        fail("export_torch_ckpt: the exported checkpoint does not read back as phase 11's")

    for what, iters in (("eval", "2"), ("train", "5")):
        t = time.perf_counter()
        rc, text = run_tool(bench_device_preprocess.main, ["--phase", what, "--iters", iters])
        line = text.strip().splitlines()[-1] if text.strip() else ""
        print(f"tools: bench_device_preprocess --phase {what} --iters {iters}, "
              f"{time.perf_counter() - t:.1f} s, exit {rc}: {line}", flush=True)
        if rc != 0 or not line.startswith("{") or json.loads(line)["value"] <= 0:
            fail(f"bench_device_preprocess --phase {what} printed no result")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rpo_tpu_torch.device import resolve_device
    from rpo_tpu_torch.methods import cocoop as cocoop_mod
    from rpo_tpu_torch.methods import coop as coop_mod
    from rpo_tpu_torch.methods import rpo as rpo_core
    from rpo_tpu_torch.methods import zsclip
    from rpo_tpu_torch.methods.rpo_trainer import RPO
    from rpo_tpu_torch.models.clip.layers import layer_norm, mlp
    from rpo_tpu_torch.models.clip.model import ARCHS, cast_params, init_clip
    from rpo_tpu_torch.ops import _build
    from rpo_tpu_torch.ops import fused_rect_layer as frl
    from rpo_tpu_torch.ops import fused_text_layer as ftl
    from rpo_tpu_torch.ops.attention import multihead_attention_rect
    from rpo_tpu_torch.ops import masked_attention as ma
    from rpo_tpu_torch.ops import rect_attention as ra
    from rpo_tpu_torch.ops.selftest import (FUSED_TEXT_CHECKS, RECT_HALF_CHECKS, TRAIN_SHAPES,
                                            first_max_abs_err, fused_qkv, path_layout_qkv,
                                            run_selftest, train_layout_qkv)
    from rpo_tpu_torch.ops.selftest import attention_bias as mask
    from rpo_tpu_torch.ops.selftest import random_block as text_block
    from rpo_tpu_torch.tools.timing import (call_ms, device_ms, device_ms_by_kernel, fmt_ms,
                                            stream_ms)

    # ---- 1. device --------------------------------------------------------
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    resolve_device()  # the package's settings, as every entry point has them
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    if any(flags):
        fail(f"resolve_device left a reduced-precision flag on: {flags}")
    bw, peak = next(((b, p) for frag, b, p in PEAKS if frag in name), PEAKS[-1][1:])
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} | allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction} | peaks "
          f"{bw / 1e12} TB/s, {peak / 1e12} TFLOP/s bf16", flush=True)

    # ---- 2. build ---------------------------------------------------------
    secs, logs = _build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if any(w in ln for w in ("entry function", "registers", "spill"))]
    print(f"build: {len(logs)} source(s) in {secs:.1f} s", flush=True)
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    # ---- 3. kernels against their plain versions --------------------------
    # the correctness checks are the package's kernel selftest
    # (rpo_tpu_torch/ops/selftest.py), run before any timing; the timings
    # below draw their own inputs
    selftest = run_selftest(verbose=False, device=torch.device("cuda"))
    for check, status in selftest["checks"].items():
        print(f"{check}: {status}", flush=True)
    print(f"kernel selftest: {selftest['value']} of {selftest['total']} checks pass in "
          f"{selftest['seconds']} s", flush=True)
    failed = [check for check, status in selftest["checks"].items() if not status.startswith("ok")]
    if failed:
        fail(f"kernel selftest: {len(failed)} of {selftest['total']} checks failed, the first "
             f"{failed[0]}: {selftest['checks'][failed[0]]}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_shapes = dict(TRAIN_SHAPES)

    # timing: each kernel at its main-path shape, beside plain, SDPA, bound
    def time_attention(label, kernel, plain, library, n_bytes, n_flops, bound_fmt=".4f"):
        """The kernel and SDPA on the three timers of rpo_tpu_torch.tools.timing:
        a call with its launch (ms, as every kernel here), back-to-back calls
        (stream_ms) and the device time alone (device_ms)."""
        t = {"ms": call_ms(kernel, 30), "stream_ms": stream_ms(kernel, 30),
             "device_ms": device_ms(kernel, 30), "plain_ms": call_ms(plain, 10),
             "library_ms": call_ms(library, 30), "library_stream_ms": stream_ms(library, 30),
             "library_device_ms": device_ms(library, 30)}
        t["bound_ms"], t["bound_by"] = bound(n_bytes, n_flops, bw, peak)
        dev = (f"{t['device_ms'] / t['library_device_ms']:.2f}"
               if t["device_ms"] and t["library_device_ms"] else "not measured")
        print(f"time {label} bf16 on {smi}: kernel {t['ms']:.4f} ms a call (back to back "
              f"{t['stream_ms']:.4f}, device {fmt_ms(t['device_ms'])}), plain {t['plain_ms']:.4f} "
              f"ms, library SDPA {t['library_ms']:.4f} ms a call (back to back "
              f"{t['library_stream_ms']:.4f}, device {fmt_ms(t['library_device_ms'])}), bound "
              f"{t['bound_ms']:{bound_fmt}} ms by {t['bound_by']} ({n_bytes / 1e6:.2f} MB, "
              f"{n_flops / 1e9:.3f} GFLOP); kernel / SDPA a call {t['ms'] / t['library_ms']:.2f}, "
              f"back to back {t['stream_ms'] / t['library_stream_ms']:.2f}, device {dev}; kernel "
              f"a call / bound {t['ms'] / t['bound_ms']:.1f}", flush=True)
        return t

    B, H, Lq, Lk, D = 100, 12, 221, 197, 64
    q, k, v = path_layout_qkv(gen, B, H, Lq, Lk, D, torch.bfloat16)
    rect_attn_times = time_attention(
        "rect_attention (100,12,221,197,64)", lambda: ra.rect_attention(q, k, v),
        lambda: ra.rect_attention_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v),
        2 * B * H * (Lq + Lk + Lk + Lq) * D, 4 * B * H * Lq * Lk * D)
    q, k, v = fused_qkv(gen, B, H, Lk, D, torch.bfloat16)
    sq_times = time_attention(
        "rect_attention (100,12,197,197,64)", lambda: ra.rect_attention(q, k, v),
        lambda: ra.rect_attention_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v),
        2 * B * H * Lk * 4 * D, 4 * B * H * Lk * Lk * D)
    train_times = {}
    for label, (B, H, Lq, Lk, D) in train_shapes.items():
        q, k, v = train_layout_qkv(gen, B, H, Lq, Lk, D, torch.bfloat16)
        train_times[label] = time_attention(
            f"rect_attention {(B, H, Lq, Lk, D)} {label}", lambda: ra.rect_attention(q, k, v),
            lambda: ra.rect_attention_reference(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v),
            2 * B * H * (Lq + Lk + Lk + Lq) * D, 4 * B * H * Lq * Lk * D, bound_fmt=".5f")
    # the baselines' train steps (phase 13): the frozen image tower's
    # square 197 rows at CoOp's batch 32 and at batch 1 (CoCoOp, LP)
    for B in (BASELINE_TRAIN_BATCH, 1):
        q, k, v = fused_qkv(gen, B, 12, 197, 64, torch.bfloat16)
        train_times[f"baseline train batch {B}"] = time_attention(
            f"rect_attention ({B},12,197,197,64) baseline train, frozen tower",
            lambda: ra.rect_attention(q, k, v), lambda: ra.rect_attention_reference(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v), 2 * B * 12 * 197 * 4 * 64,
            4 * B * 12 * 197 * 197 * 64, bound_fmt=".5f")
    # the masked kernel at the text towers' lengths: RPO set-up (77), CoOp
    # (24), zero-shot (16), each with the shared causal mask
    masked_times = {}
    B, H, D = 51, 8, 64
    for L in (77, 24, 16):
        q, k, v = fused_qkv(gen, B, H, L, D, torch.bfloat16)
        bias = mask("causal", B, L)
        bias_q = bias.to(q.dtype)  # SDPA takes a float mask in q's dtype
        masked_times[L] = time_attention(
            f"masked_attention ({B},{H},{L},{L},{D}) shared causal",
            lambda: ma.masked_attention(q, k, v, bias),
            lambda: ma.masked_attention_reference(q, k, v, bias),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias_q),
            2 * B * H * L * 4 * D + 4 * L * L, 4 * B * H * L * L * D, bound_fmt=".5f")
    # under grad in the baselines' text towers (phase 13): CoOp's 10 classes
    # a step and CoCoOp's 10 at batch 1, CoCoOp's chunk of 8 images x 10
    # classes at batch 16, L = 16 on Synthetic; the backward is the plain
    # recompute (dq, dk and dv: the prompts' embeddings require grad)
    for B in (10, 80):
        L = 16
        q, k, v = (t.detach().requires_grad_(True) for t in fused_qkv(gen, B, H, L, D,
                                                                        torch.bfloat16))
        bias = mask("causal", B, L)
        bias_q = bias.to(q.dtype)
        g = torch.randn(B, H, L, D, generator=gen, device="cuda").to(q.dtype)
        with torch.no_grad():
            t = time_attention(
                f"masked_attention ({B},{H},{L},{L},{D}) shared causal, baseline train text tower",
                lambda: ma.masked_attention(q, k, v, bias),
                lambda: ma.masked_attention_reference(q, k, v, bias),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias_q),
                2 * B * H * L * 4 * D + 4 * L * L, 4 * B * H * L * L * D, bound_fmt=".5f")
            t["backward_plain_ms"] = call_ms(lambda: ra._attention_bwd_math(
                q, k, v, bias, g, (True, True, True)), 30)
        print(f"time masked_attention backward ({B},{H},{L},{L},{D}) on {smi}: the plain "
              f"recompute (dq, dk, dv) {t['backward_plain_ms']:.4f} ms a call against the "
              f"kernel's forward {t['ms']:.4f}", flush=True)
        masked_times[f"train {B}x{L}"] = t

    N, L, d, heads = FUSED_TEXT_CHECKS[0][1]
    blk = ftl.with_kernel_layout(text_block(gen, d))
    x = torch.randn(N, L, d, generator=gen, device="cuda").to(torch.bfloat16)
    causal = mask("causal", 1, L)[0, 0]
    with torch.no_grad():
        fused_fn = lambda: ftl.fused_text_layer(x, blk, heads, causal)  # noqa: E731
        fused_times = {"ms": call_ms(fused_fn, 30), "stream_ms": stream_ms(fused_fn, 30),
                       "device_ms": device_ms(fused_fn, 30)}
        fused_plain_ms = call_ms(lambda: ftl.fused_text_layer_reference(x, blk, heads, causal), 10)
    # each input read once (x, the weights, the mask), the output written once;
    # FLOPs: the four projections (12 d^2 MACs a row) and the two attention products
    n_weights = 12 * d * d + 13 * d
    n_bytes = 2 * (2 * N * L * d + n_weights) + 4 * L * L
    n_flops = 2 * N * L * 12 * d * d + 4 * N * heads * L * L * (d // heads)
    fused_bound_ms, fused_bound_by = bound(n_bytes, n_flops, bw, peak)
    print(f"time fused_text_layer ({N},{L},{d}) {heads} heads bf16 on {smi}: kernel "
          f"{fused_times['ms']:.4f} ms a call (back to back {fused_times['stream_ms']:.4f}, device "
          f"{fmt_ms(fused_times['device_ms'])}), plain {fused_plain_ms:.4f} ms, library none (no "
          f"single PyTorch call computes a pre-LN block with QuickGELU and these roundings), bound "
          f"{fused_bound_ms:.4f} ms by {fused_bound_by} ({n_bytes / 1e6:.2f} MB, "
          f"{n_flops / 1e9:.2f} GFLOP); kernel a call / bound "
          f"{fused_times['ms'] / fused_bound_ms:.1f}", flush=True)
    # its launch plan at the phase-3 shapes, and what ptxas said of its source
    for _, shape in FUSED_TEXT_CHECKS:
        print(f"plan fused_text_layer {shape[:3]} {shape[3]} heads: {ftl.launch_plan(*shape)}",
              flush=True)
    for ln in logs.get("fused_text_layer", "").splitlines():
        if any(w in ln for w in ("registers", "spill", "smem")):
            print(f"  ptxas fused_text_layer.cu: {ln.split(':', 1)[-1].strip()}")

    # the fused rect halves: each half's launches at each shape (the
    # wrapper's plans, which the CPU tests hold to the source's constants),
    # and what ptxas said of the halves' kernels
    plans = {}
    for label, (B, L, d, heads, n_kv) in RECT_HALF_CHECKS:
        plans[label] = {"fused_rect_attn_half": frl.attn_launch_plan(B, L, d, heads, n_kv),
                        "fused_mlp_half": frl.mlp_launch_plan(B * L, d)}
        for what, plan in plans[label].items():
            print(f"plan {what} {label} {(B, L, d)} n_kv {n_kv}: {plan}", flush=True)
    kernel_name = ""
    for ln in logs.get("fused_rect_layer", "").splitlines():
        if "entry function" in ln:
            kernel_name = ln.split("'")[1] if "'" in ln else ln
        elif any(w in kernel_name for w in ("fused_mlp_half", "fused_rect_attn_half")) and any(
                w in ln for w in ("registers", "spill", "smem")):
            print(f"  ptxas fused_rect_layer.cu {kernel_name}: {ln.split(':', 1)[-1].strip()}")
    # timing at the RPO eval layer and the square tower, beside the plain
    # versions and the unfused port path on the card (layer_norm, the
    # projections on cuBLAS, the rect kernel, the residual adds), a yardstick
    # the fused path never calls; no single PyTorch call computes either
    # half.  A call (ms), back-to-back calls and the device time, split by
    # kernel, of the half and of the unfused path
    rect_times = {}
    for label, (B, L, d, heads, n_kv) in RECT_HALF_CHECKS[:2]:
        blk = ftl.with_kernel_layout(text_block(gen, d))
        x = torch.randn(B, L, d, generator=gen, device="cuda").to(torch.bfloat16)
        n_x = 2 * 2 * B * L * d  # x read once, the output written once, bf16
        attn_w = 2 * (4 * d * d + 6 * d)
        mlp_w = 2 * (8 * d * d + 7 * d)
        dh = d // heads
        attn_flops = (2 * (2 * B * L * d * d + 2 * B * n_kv * d * d)
                      + 4 * B * heads * L * n_kv * dh)
        mlp_flops = 16 * B * L * d * d
        with torch.no_grad():
            runs = {
                "fused_rect_attn_half": (
                    lambda: frl.fused_rect_attn_half(x, blk["ln_1"], blk["attn"], heads, n_kv,
                                                     kernel=blk["kernel"]),
                    lambda: frl.fused_rect_attn_half_reference(x, blk["ln_1"], blk["attn"],
                                                               heads, n_kv),
                    lambda: x + multihead_attention_rect(layer_norm(x, blk["ln_1"]), blk["attn"],
                                                         heads, n_kv, ra.rect_attention),
                    n_x + attn_w, attn_flops),
                "fused_mlp_half": (
                    lambda: frl.fused_mlp_half(x, blk["ln_2"], blk["mlp"], kernel=blk["kernel"]),
                    lambda: frl.fused_mlp_half_reference(x, blk["ln_2"], blk["mlp"]),
                    lambda: x + mlp(layer_norm(x, blk["ln_2"]), blk["mlp"]),
                    n_x + mlp_w, mlp_flops),
            }
            for what, (kernel_fn, plain_fn, unfused_fn, n_bytes, n_flops) in runs.items():
                t = {"ms": call_ms(kernel_fn, 30), "stream_ms": stream_ms(kernel_fn, 30)}
                split = t["device_ms_by_kernel"] = device_ms_by_kernel(kernel_fn, 30)
                t["device_ms"] = None if split is None else sum(split.values())
                t["plain_ms"] = call_ms(plain_fn, 10)
                t["unfused_ms"] = call_ms(unfused_fn, 30)
                t["unfused_stream_ms"] = stream_ms(unfused_fn, 30)
                t["unfused_device_ms"] = device_ms(unfused_fn, 30)
                t["bound_ms"], t["bound_by"] = bound(n_bytes, n_flops, bw, peak)
                rect_times.setdefault(what, {})[label] = t
                parts = ", ".join(f"{k} {ms:.4f}" for k, ms in sorted(
                    (split or {}).items(), key=lambda kv: -kv[1]))
                print(f"time {what} {label} {(B, L, d)} n_kv {n_kv} bf16 on {smi}: kernel "
                      f"{t['ms']:.4f} ms a call (back to back {t['stream_ms']:.4f}, device "
                      f"{fmt_ms(t['device_ms'])}: {parts or 'not measured'}), plain "
                      f"{t['plain_ms']:.4f} ms, unfused {t['unfused_ms']:.4f} ms a call (back to "
                      f"back {t['unfused_stream_ms']:.4f}, device "
                      f"{fmt_ms(t['unfused_device_ms'])}), library none, bound "
                      f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({n_bytes / 1e6:.1f} MB, "
                      f"{n_flops / 1e9:.1f} GFLOP)", flush=True)
        del runs

    # ---- the shared backbone and data --------------------------------------
    classnames = [f"object category {i}" for i in range(N_CLS)]
    rng = np.random.RandomState(2)
    batches = [rng.randint(0, 256, (EVAL_BATCH, 224, 224, 3)).astype(np.uint8)
               for _ in range(N_BATCHES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clip = cast_params(init_clip(torch.Generator(device="cuda").manual_seed(1), ARCHS["ViT-B/16"]),
                       torch.bfloat16)
    torch.cuda.synchronize()
    print(f"backbone: ViT-B/16 drawn from seed 1 in bf16 in {time.perf_counter() - t0:.2f} s, "
          "shared by phases 4-7", flush=True)
    n_layers = ARCHS["ViT-B/16"].vision_layers
    text_layers = ARCHS["ViT-B/16"].text_layers
    rect_launches, masked_launches = {}, {}

    # ---- 4. RPO ViT-B/16 bf16 eval through the trainer ----------------------
    ra.launches = ma.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rpo = RPO(classnames, "a photo of a _.", K=K, backbone="ViT-B/16", prec="fp16", seed=1,
              clip_params=clip)
    rpo.text_features()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    masked_launches["RPO set-up"] = check_launches("RPO set-up", ma, text_layers)
    logits, batch_s = run_batches(rpo.eval_step, batches)
    rect_launches["RPO eval"] = check_launches("RPO eval", ra, n_layers * N_BATCHES)
    check_launches("RPO eval", ma, text_layers)
    print(f"RPO launches: masked {ma.launches} = {text_layers} (set-up text K/V), rect "
          f"{ra.launches} = {n_layers} x {N_BATCHES}", flush=True)
    # fully plain: the text K/V cache built with the plain masked attention,
    # the vision tower on the plain rect attention
    plain_frozen = rpo_core.make_frozen(clip, rpo.task, masked_attn=ma.masked_attention_reference)
    with torch.no_grad():
        plain_tf = rpo_core.encode_text_with_prompts(rpo.params, plain_frozen, rpo.task)
        plain = [rpo_core.rpo_logits(
            rpo.params, plain_frozen, rpo.task, rpo._normalize(torch.from_numpy(images).cuda()),
            text_f=plain_tf, rect_attn=ra.rect_attention_reference) for images in batches]
    check_logits(f"slice RPO ViT-B/16 bf16 K={K} n_cls={N_CLS}", logits, plain,
                 against="both plain versions (text K/V cache and vision tower)")
    report_rate("RPO", setup_s, batch_s, smi)
    profile_eval_step(rpo.eval_step, batches[-1], smi, "RPO")
    rpo_rect_logits = logits  # phase 9 is held against them
    del rpo, plain, plain_frozen, plain_tf

    # ---- 5. CoOp ViT-B/16 bf16 eval through the trainer ---------------------
    ra.launches = ma.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coop = coop_mod.CoOp(classnames, n_ctx=N_CTX, csc=False, position="end", ctx_init="",
                         backbone="ViT-B/16", prec="fp16", seed=1, clip_params=clip)
    coop.text_features()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    masked_launches["CoOp text features"] = check_launches("CoOp text features", ma, text_layers)
    logits, batch_s = run_batches(coop.eval_step, batches)
    rect_launches["CoOp eval"] = check_launches("CoOp eval", ra, n_layers * N_BATCHES)
    check_launches("CoOp eval", ma, text_layers)
    print(f"CoOp launches: masked {ma.launches} = {text_layers} (text features at L = "
          f"{coop.task.text_len}), rect {ra.launches} = {n_layers} x {N_BATCHES}", flush=True)
    with torch.no_grad():
        plain_tf = coop_mod.coop_text_features(coop.params, clip, coop.task,
                                               masked_attn=ma.masked_attention_reference)
        plain = [coop_mod.coop_logits(
            coop.params, clip, coop.task, coop._normalize(torch.from_numpy(images).cuda()),
            text_f=plain_tf, rect_attn=ra.rect_attention_reference,
            masked_attn=ma.masked_attention_reference) for images in batches]
    check_logits(f"slice CoOp ViT-B/16 bf16 N_CTX={N_CTX} end n_cls={N_CLS}", logits, plain,
                 SINGLE_PAIR_ARGMAX_AGREE)
    report_rate("CoOp", setup_s, batch_s, smi)
    profile_eval_step(coop.eval_step, batches[-1], smi, "CoOp")

    # ---- 6. zero-shot CLIP ---------------------------------------------------
    ra.launches = ma.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs = zsclip.ZeroshotCLIP(classnames, "Caltech101", backbone="ViT-B/16", seed=1,
                             clip_params=clip)
    zs.text_features()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    masked_launches["ZeroshotCLIP text features"] = check_launches("ZeroshotCLIP text", ma,
                                                                   text_layers)
    logits, batch_s = run_batches(zs.eval_step, batches)
    rect_launches["ZeroshotCLIP eval"] = check_launches("ZeroshotCLIP eval", ra,
                                                        n_layers * N_BATCHES)
    check_launches("ZeroshotCLIP eval", ma, text_layers)
    tokens = zs.text_tokens()
    print(f"ZeroshotCLIP launches: masked {ma.launches} = {text_layers} (1 template at L = "
          f"{tokens.shape[-1]}), rect {ra.launches} = {n_layers} x {N_BATCHES}", flush=True)
    with torch.no_grad():
        plain_tf = zsclip.zeroshot_text_features(clip, zs.clip_cfg, tokens,
                                                 ma.masked_attention_reference)
        plain = [zsclip.zeroshot_logits(
            clip, zs.clip_cfg, zs._normalize(torch.from_numpy(images).cuda()), plain_tf,
            ra.rect_attention_reference, ma.masked_attention_reference) for images in batches]
    check_logits(f"slice ZeroshotCLIP ViT-B/16 bf16 Caltech101 n_cls={N_CLS}", logits, plain,
                 SINGLE_PAIR_ARGMAX_AGREE)
    report_rate("ZeroshotCLIP", setup_s, batch_s, smi)

    ra.launches = ma.launches = 0
    zs2 = zsclip.ZeroshotCLIP2(classnames, "Caltech101", backbone="ViT-B/16", seed=1,
                               clip_params=clip)
    n_templates = len(zs2.templates)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = zs2.text_features()
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t0
    masked_launches["ZeroshotCLIP2 text features"] = check_launches(
        "ZeroshotCLIP2 text", ma, text_layers * n_templates)
    check_launches("ZeroshotCLIP2 text", ra, 0)
    with torch.no_grad():
        plain_tf = zsclip.zeroshot_text_features(clip, zs2.clip_cfg, zs2.text_tokens(),
                                                 ma.masked_attention_reference)
    err = (feats - plain_tf).abs().max().item()
    min_cos = (feats * plain_tf).sum(-1).min().item()
    ok = tuple(feats.shape) == (N_CLS, 512) and bool(torch.isfinite(feats).all()) and err <= UNIT_ATOL
    print(f"ZeroshotCLIP2 text features ({n_templates} templates): masked launches "
          f"{ma.launches} = {n_templates} x {text_layers}; {text_s:.3f} s; vs plain attention "
          f"max_abs_err {err:.3e} on unit vectors (tol {UNIT_ATOL}), min cosine {min_cos:.6f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("ZeroshotCLIP2 text features disagree with the plain-attention run")

    # ---- 7. CoCoOp ViT-B/16 bf16 eval through the trainer -------------------
    ra.launches = ma.launches = ftl.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cocoop = cocoop_mod.CoCoOp(classnames, n_ctx=4, backbone="ViT-B/16", prec="fp16", seed=1,
                               clip_params=clip)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    logits, batch_s = run_batches(cocoop.eval_step, batches)
    chunk = cocoop_mod.eval_chunk(EVAL_BATCH)
    per_batch = text_layers * (EVAL_BATCH // chunk)
    fused_launches = {"CoCoOp eval": check_launches("CoCoOp eval", ftl, per_batch * N_BATCHES)}
    rect_launches["CoCoOp eval"] = check_launches("CoCoOp eval", ra, n_layers * N_BATCHES)
    check_launches("CoCoOp eval", ma, 0)
    print(f"CoCoOp launches: fused_text_layer {ftl.launches} = {text_layers} layers x "
          f"{EVAL_BATCH // chunk} chunks of {chunk} images x {N_BATCHES} (towers of "
          f"({chunk * N_CLS}, {cocoop.task.text_len}, {ARCHS['ViT-B/16'].text_width})), "
          f"rect {ra.launches} = {n_layers} x {N_BATCHES}, masked {ma.launches}", flush=True)
    label = f"slice CoCoOp ViT-B/16 bf16 N_CTX=4 n_cls={N_CLS}"
    cocoop_checks(f"{label} seed 1", cocoop, clip, batches, logits)
    report_rate("CoCoOp", setup_s, batch_s, smi)
    profile_eval_step(cocoop.eval_step, batches[-1], smi, "CoCoOp")
    del cocoop
    # the same checks on a second draw of everything random: the backbone,
    # the context and meta-net, the images
    clip2 = cast_params(init_clip(torch.Generator(device="cuda").manual_seed(2),
                                  ARCHS["ViT-B/16"]), torch.bfloat16)
    rng2 = np.random.RandomState(3)
    batches2 = [rng2.randint(0, 256, (EVAL_BATCH, 224, 224, 3)).astype(np.uint8)
                for _ in range(N_BATCHES)]
    cocoop2 = cocoop_mod.CoCoOp(classnames, n_ctx=4, backbone="ViT-B/16", prec="fp16", seed=2,
                                clip_params=clip2)
    logits2, _ = run_batches(cocoop2.eval_step, batches2)
    cocoop_checks(f"{label} seed 2", cocoop2, clip2, batches2, logits2)
    del cocoop2, clip2, batches2

    # ---- 8. cuBLAS reduced-precision bf16 reduction, off and on -------------
    rates = {False: [], True: []}
    outs = {}
    for flag in (False, True, True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        out, batch_s = run_batches(coop.eval_step, batches * 2)
        rates[flag].append(EVAL_BATCH / statistics.median(batch_s))
        outs[flag] = torch.cat(out)
    resolve_device()  # the package's setting again: off
    moved = (outs[True] - outs[False]).abs().max().item()
    print(f"flag CoOp eval on {smi}, allow_bf16_reduced_precision_reduction off/on/on/off: "
          f"{rates[False][0]:.1f} / {rates[True][0]:.1f} / {rates[True][1]:.1f} / "
          f"{rates[False][1]:.1f} images/s (median of {2 * N_BATCHES} batches each); logits "
          f"moved by up to {moved:.3e} between the settings", flush=True)
    del coop

    # ---- 9. RPO eval with the fused vision tower ---------------------------
    frl.attn_half_launches = frl.mlp_half_launches = ra.launches = ma.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rpo = RPO(classnames, "a photo of a _.", K=K, backbone="ViT-B/16", prec="fp16", seed=1,
              clip_params=clip, vision_layer=frl.fused_rect_residual_block)
    text_f = rpo.text_features()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    masked_launches["RPO fused set-up"] = check_launches("RPO fused set-up", ma, text_layers)
    logits, batch_s = run_batches(rpo.eval_step, batches)
    want = n_layers * N_BATCHES
    for counter in ("attn_half_launches", "mlp_half_launches"):
        if getattr(frl, counter) != want:
            fail(f"RPO fused eval: {counter} is {getattr(frl, counter)}, expected {want}")
    fused_rect_launches = {"RPO fused eval": frl.attn_half_launches}
    fused_mlp_launches = {"RPO fused eval": frl.mlp_half_launches}
    check_launches("RPO fused eval", ra, 0)
    check_launches("RPO fused eval", ma, text_layers)
    print(f"RPO fused launches: fused_rect_attn_half {frl.attn_half_launches} = {n_layers} x "
          f"{N_BATCHES}, fused_mlp_half {frl.mlp_half_launches} = {n_layers} x {N_BATCHES}, rect "
          f"{ra.launches}, masked {ma.launches} = {text_layers} (set-up text K/V)", flush=True)
    with torch.no_grad():
        plain = [rpo_core.rpo_logits(
            rpo.params, rpo._frozen, rpo.task, rpo._normalize(torch.from_numpy(images).cuda()),
            text_f=text_f, vision_layer=frl.fused_rect_residual_block_reference)
            for images in batches]
    label = f"slice RPO fused ViT-B/16 bf16 K={K} n_cls={N_CLS}"
    check_logits(label, logits, plain, against="the plain fused halves")
    check_logits(label, logits, rpo_rect_logits,
                 against="phase 4's run (rect_residual_block on the rect kernel)")
    report_rate("RPO fused", setup_s, batch_s, smi)
    # the CUDA launches a call of each fused half makes, measured: the
    # profiled batch's device operations of the half over the calls its
    # wrapper counted in that batch
    def zero_fused_counts():
        frl.attn_half_launches = frl.mlp_half_launches = 0

    seen, _ = profile_eval_step(rpo.eval_step, batches[-1], smi, "RPO fused",
                             before=zero_fused_counts)
    cuda_per_call = {}
    for what, counter in (("fused_rect_attn_half", "attn_half_launches"),
                          ("fused_mlp_half", "mlp_half_launches")):
        want = plans[RECT_HALF_CHECKS[0][0]][what]["launches"]
        calls, kernels = getattr(frl, counter), seen.get(f"{what} kernel", 0)
        cuda_per_call[what] = kernels / calls if calls else None
        print(f"RPO fused profiled batch: {kernels} {what} kernel launches on the device over "
              f"{calls} calls, {cuda_per_call[what]} a call (the plan: {want})", flush=True)
        if calls != n_layers or cuda_per_call[what] != want:
            fail(f"RPO fused profiled batch: {what} made {kernels} kernel launches in {calls} "
                 f"calls, expected {want} a call over {n_layers} calls")
    del rpo, plain

    # ---- 10. RPO ViT-B/16 bf16 training through the trainer -----------------
    train_rng = np.random.RandomState(4)
    train_batches = [(train_rng.randint(0, 256, (TRAIN_BATCH, 224, 224, 3)).astype(np.uint8),
                      train_rng.randint(0, N_CLS, TRAIN_BATCH), np.ones(TRAIN_BATCH, np.float32))
                     for _ in range(N_TRAIN_CHECK + TRAIN_WARMUP + N_TRAIN_TIMED)]
    train_batches[0][2][-1] = 0.0  # a padded row in the first batch
    ra.launches = ma.launches = ftl.launches = frl.attn_half_launches = frl.mlp_half_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rpo = RPO(classnames, "a photo of a _.", K=K, backbone="ViT-B/16", prec="fp16", seed=1,
              clip_params=clip)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    masked_launches["RPO train set-up"] = check_launches("RPO train set-up", ma, text_layers)
    first_prompts = {key: t.clone() for key, t in rpo.params.items()}
    losses = [rpo.train_step(*batch, TRAIN_LR)[0] for batch in train_batches[:N_TRAIN_CHECK]]
    torch.cuda.synchronize()
    eager_losses = torch.stack(losses)
    eager_prompts = {key: t.clone() for key, t in rpo.params.items()}
    rect_launches["RPO train"] = check_launches("RPO train", ra, 2 * n_layers * N_TRAIN_CHECK)
    check_launches("RPO train", ma, text_layers)
    check_launches("RPO train", ftl, 0)
    if frl.attn_half_launches or frl.mlp_half_launches:
        fail("RPO train launched a fused rect half")
    print(f"RPO train launches: masked {ma.launches} = {text_layers} (set-up text K/V), rect "
          f"{ra.launches} = 2 x {n_layers} x {N_TRAIN_CHECK} steps (each layer: the "
          f"{TRAIN_BATCH}x197 frozen rows, the {TRAIN_BATCH}x{K} prompt rows over them), "
          f"fused 0", flush=True)

    # the first step and ten steps against the same steps fully on the plain
    # versions: a K/V cache built with the plain masked attention, the plain
    # rect attention in the split tower
    refs = dict(rect_attn=ra.rect_attention_reference, masked_attn=ma.masked_attention_reference)
    rpo.set_ckpt_state(rpo.model_name, first_prompts)  # the first prompts, a fresh optimizer
    plain = RPO(classnames, "a photo of a _.", K=K, backbone="ViT-B/16", prec="fp16", seed=1,
                clip_params=clip)
    plain._frozen = rpo_core.make_frozen(clip, plain.task, masked_attn=ma.masked_attention_reference)
    loss, logits, grads = rpo.loss_and_grads(*train_batches[0])
    p_loss, p_logits, p_grads = plain.loss_and_grads(*train_batches[0], **refs)
    if tuple(logits.shape) != (TRAIN_BATCH, N_CLS) or not bool(torch.isfinite(logits).all()):
        fail(f"RPO train logits have shape {tuple(logits.shape)} or are not finite")
    loss_err = abs(loss.item() - p_loss.item())
    logits_err = (logits - p_logits).abs().max().item()
    failed = [] if loss_err <= TRAIN_LOSS_ATOL and logits_err <= SLICE_ATOL else ["loss or logits"]
    parts = []
    for key, g in grads.items():
        want = p_grads[key]
        err = (g - want).abs().max().item()
        rel = err / want.abs().max().item()
        cos = F.cosine_similarity(g.flatten().double(), want.flatten().double(), dim=0).item()
        finite = bool(torch.isfinite(g).all())
        ok = finite and rel <= TRAIN_GRAD_REL and cos >= TRAIN_GRAD_COS
        parts.append(f"{key} {tuple(g.shape)} max_abs_err {err:.3e} (max|g| "
                     f"{want.abs().max().item():.3e}, relative {rel:.3e}, tol {TRAIN_GRAD_REL}), "
                     f"cosine {cos:.6f} (>= {TRAIN_GRAD_COS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(key)
    print(f"slice RPO train ViT-B/16 bf16 K={K} n_cls={N_CLS} batch {TRAIN_BATCH} (one padded "
          f"row), first step vs both plain versions: loss {loss.item():.6f} vs {p_loss.item():.6f} "
          f"(err {loss_err:.3e}, tol {TRAIN_LOSS_ATOL:g}); logits max_abs_err {logits_err:.3e} "
          f"(tol {SLICE_ATOL}); " + "; ".join(parts), flush=True)
    if failed:
        fail(f"RPO train first step disagrees with the plain run: {', '.join(failed)}")
    p_losses = [plain.train_step(*batch, TRAIN_LR, **refs)[0]
                for batch in train_batches[:N_TRAIN_CHECK]]
    losses, p_losses = torch.stack(losses), torch.stack(p_losses)
    steps_err = (losses - p_losses).abs().max().item()
    ok = steps_err <= TRAIN_LOSS_ATOL and bool(torch.isfinite(losses).all())
    print(f"slice RPO train {N_TRAIN_CHECK} steps at LR {TRAIN_LR}: losses "
          f"{[round(x, 5) for x in losses.tolist()]}; plain {[round(x, 5) for x in p_losses.tolist()]}; "
          f"max_abs_err {steps_err:.3e} (tol {TRAIN_LOSS_ATOL:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("RPO train losses disagree with the plain run")
    del plain, p_grads, grads

    # train images/s: the run goes on from the first prompts, synchronised
    # steps from the host's uint8 batch to the updated prompts
    for batch in train_batches[N_TRAIN_CHECK:N_TRAIN_CHECK + TRAIN_WARMUP]:
        rpo.train_step(*batch, TRAIN_LR)
    step_s = []
    for batch in train_batches[N_TRAIN_CHECK + TRAIN_WARMUP:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        rpo.train_step(*batch, TRAIN_LR)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    med = statistics.median(step_s)
    print(f"RPO train on {smi}: setup {setup_s:.2f} s; step seconds median {med:.5f} (min "
          f"{min(step_s):.5f}, max {max(step_s):.5f}, {len(step_s)} steps after {TRAIN_WARMUP} "
          f"warm-up); {TRAIN_BATCH / med:.1f} train images/s at the median step, "
          f"{TRAIN_BATCH * len(step_s) / sum(step_s):.1f} over all", flush=True)
    profile_eval_step(lambda batch: rpo.train_step(*batch, TRAIN_LR), train_batches[-1], smi,
                      "RPO", "train step")
    phase10_rate = TRAIN_BATCH / statistics.median(step_s)
    graph_launches, rect_replayed = graphed_train(rpo, train_batches, first_prompts, eager_losses,
                                                  eager_prompts, phase10_rate, smi, n_layers)
    rect_launches.update(graph_launches)
    del rpo

    # ---- 11. RPO run: the CLI trains main_K24 on Synthetic -----------------
    run_dir = tempfile.mkdtemp(prefix="rpo_run_")
    try:
        phase11 = rpo_run(run_dir, smi, phase10_rate, n_layers, text_layers)
        rect_launches.update(phase11["launches"]["rect"])
        masked_launches.update(phase11["launches"]["masked"])
        rect_replayed.update(phase11["launches"]["rect_replayed"])

        # ---- 12. RPO run, one dispatch a group of steps ---------------------
        run_launches = rpo_run_one_dispatch(run_dir, smi, phase11, n_layers, text_layers)
        rect_launches.update(run_launches["rect"])
        masked_launches.update(run_launches["masked"])
        rect_replayed.update(run_launches["rect_replayed"])

        # ---- 13. the baselines: CoOp, CoCoOp, LP, zero-shot, through the CLI --
        t13 = time.perf_counter()
        baselines = baseline_runs(os.path.join(run_dir, "baselines"), smi, n_layers, text_layers)
        rect_launches.update(baselines["launches"]["rect"])
        masked_launches.update(baselines["launches"]["masked"])
        fused_launches.update(baselines["launches"]["fused"])
        rect_replayed.update(baselines["launches"]["rect_replayed"])
        masked_replayed = baselines["launches"]["masked_replayed"]
        print(f"chip_smoke: phase 13 in {time.perf_counter() - t13:.1f} s", flush=True)

        # ---- 14. the ResNet towers: zero-shot, CoOp's RN protocol, a checkpoint --
        t14 = time.perf_counter()
        resnet = resnet_runs(os.path.join(run_dir, "resnet"), smi, classnames)
        masked_launches.update(resnet["masked"])
        masked_replayed.update(resnet["masked_replayed"])
        print(f"chip_smoke: phase 14 in {time.perf_counter() - t14:.1f} s", flush=True)

        # ---- 15. the file-backed datasets: readers, JPEG decode, CLI runs ---
        t15 = time.perf_counter()
        files = file_datasets(os.path.join(run_dir, "files"), smi, phase11, n_layers,
                              text_layers)
        rect_launches.update(files["rect"])
        masked_launches.update(files["masked"])
        rect_replayed.update(files["rect_replayed"])
        print(f"chip_smoke: phase 15 in {time.perf_counter() - t15:.1f} s", flush=True)

        # ---- 16. the tools: kernel selftest CLI, profiler, export, bench ---
        t16 = time.perf_counter()
        tools_phase(run_dir, smi, selftest["total"])
        print(f"chip_smoke: phase 16 in {time.perf_counter() - t16:.1f} s", flush=True)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    print(f"chip_smoke: phases 1-16 in {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "rect_attention",
        "route": "cuda",
        "source": "rpo_tpu_torch/ops/csrc/rect_attention.cu",
        "replaces": "rpo_tpu/ops/pallas_attention.py:196",
        "also_replaces": "rpo_tpu/ops/pallas_attention.py:114",
        "launches": sum(rect_launches.values()),
        "launches_by_path": rect_launches,
        # a graph's kernels run at each replay, where no wrapper is called:
        # the launches its capture recorded times its replays, by path
        "replayed_by_path": rect_replayed,
        "max_abs_err": first_max_abs_err(selftest, "rect_attention"),
        **rect_attn_times,
        "square_197": sq_times,
        "train_frozen_rows": train_times["train frozen rows"],
        "train_prompt_rows": train_times["train prompt rows"],
        "baseline_train_batch_32": train_times[f"baseline train batch {BASELINE_TRAIN_BATCH}"],
        "baseline_train_batch_1": train_times["baseline train batch 1"],
    }, {
        "name": "masked_attention",
        "route": "cuda",
        "source": "rpo_tpu_torch/ops/csrc/rect_attention.cu",
        "replaces": "rpo_tpu/ops/pallas_attention.py:262",
        "launches": sum(masked_launches.values()),
        "launches_by_path": masked_launches,
        "replayed_by_path": masked_replayed,
        "max_abs_err": first_max_abs_err(selftest, "masked_attention"),
        **masked_times[77],
        "L24": masked_times[24],
        "L16": masked_times[16],
        "train_10x16": masked_times["train 10x16"],
        "train_80x16": masked_times["train 80x16"],
    }, {
        "name": "fused_text_layer",
        "route": "cuda",
        "source": "rpo_tpu_torch/ops/csrc/fused_text_layer.cu",
        "replaces": "rpo_tpu/ops/fused_text_layer.py:215",
        "launches": sum(fused_launches.values()),
        "launches_by_path": fused_launches,
        "max_abs_err": first_max_abs_err(selftest, "fused_text_layer"),
        **fused_times,
        "plain_ms": fused_plain_ms,
        "bound_ms": fused_bound_ms,
        "bound_by": fused_bound_by,
        "library_ms": None,
    }] + [{
        "name": what,
        "route": "cuda",
        "source": "rpo_tpu_torch/ops/csrc/fused_rect_layer.cu",
        "replaces": f"rpo_tpu/ops/fused_rect_layer.py:{line}",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": first_max_abs_err(selftest, what),
        **rect_times[what][RECT_HALF_CHECKS[0][0]],
        "library_ms": None,
        "square_197": {**rect_times[what][RECT_HALF_CHECKS[1][0]], "library_ms": None},
        "cuda_launches_per_call": cuda_per_call[what],
    } for what, line, by_path in (("fused_rect_attn_half", 185, fused_rect_launches),
                                  ("fused_mlp_half", 225, fused_mlp_launches))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
