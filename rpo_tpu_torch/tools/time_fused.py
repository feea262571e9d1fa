"""Time builds of the fused layer kernels side by side, in one process.

    python3 -m rpo_tpu_torch.tools.time_fused \\
        [--source LABEL=DIR/fused_text_layer.cu ...] [--rounds 2] [--json PATH]
        [--phases]

The variants: "this", the checkout's sources; each ``--source``, an
earlier ``fused_text_layer.cu`` with the same C entry points (an earlier
commit's, written out with ``git show``).  Each ``#include "X.cuh"`` line
of a source is replaced by the text of the ``X.cuh`` that lies beside it,
so each variant builds from one file against its own headers.  Where a
``fused_rect_layer.cu`` lies beside it too, that variant's rect-layer
halves are timed as well.  All are built at once with the package's nvcc
flags, and run under the same wrappers (``ops/fused_text_layer.py``,
``ops/fused_rect_layer.py``): an earlier rect-layer library takes the same
arguments, and its attention half, which needs a (B * L, 3d) scratch, uses
the front of the (B * L, 4d) one the wrapper allocates.

The shapes: ``fused_text_layer`` at the five shapes of ``chip_smoke.py``'s
phase-3 checks, ``fused_rect_attn_half`` at (100, 221, 768) with n_kv 197,
and ``fused_mlp_half`` at (100, 221, 768), (3, 43, 768) (129 rows, one past
a 128-row tile) and (2, 64, 64) (d = 64). At each shape the variants'
outputs are first compared with the checkout's (``torch.equal``, and where
they differ, how many elements and by how much) and held to the plain
version (2e-2 x max(|plain|, 1) each element, as phase 3 does), then the
variants are timed in order and in reverse, ``--rounds`` times in all, on
the three timers of ``timing``. One line per reading, with the card's name
and power limit; ``--json`` writes them all.

Where a call launches more than one kernel (the rect-layer halves), its
device time is also split by kernel.
``--phases`` also builds the checkout's ``fused_text_layer.cu`` with
``-DFUSED_TEXT_PHASES`` and runs it at the CoCoOp chunk: thread 0 of block 0
sums its SM clock by phase of the layer (set-up and LN1, q/k/v products,
attention, out projection, LN2, fc products, QuickGELU, proj products, the
MLP's epilogue), and each phase's share of the clocks is printed beside that
share of the build's device time; then the clocks of three parts inside them
(the weight ring's waits and barriers, the attention's scores and softmax).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..ops import _build
from ..ops import fused_rect_layer as frl
from ..ops import fused_text_layer as ftl
from ..ops.selftest import random_block
from .timing import call_ms, device_ms, device_ms_by_kernel, fmt_ms, stream_ms

HEADER = "fused_layer_common.cuh"
INCLUDE = f'#include "{HEADER}"'
TOL = 2e-2
N_CALLS = 30
# (label, (N, L, d, heads)): chip_smoke.py's fused_checks
TEXT_SHAPES = [
    ("CoCoOp eval chunk, the slice", (510, 16, 512, 8)),
    ("the JAX selftest shape", (408, 16, 512, 8)),
    ("ragged N, TINY widths, head dim 32", (13, 16, 64, 2)),
    ("L 80 (77 padded)", (4, 80, 512, 8)),
    ("d 768, L 80: the MLP in column passes", (3, 80, 768, 12)),
]
RECT_SHAPE = (100, 221, 768, 12, 197)  # B, L, d, heads, n_kv
# (label, (B, L, d)) of fused_mlp_half
MLP_SHAPES = [
    ("the RPO eval layer", (100, 221, 768)),
    ("129 rows, one past a 128-row tile", (3, 43, 768)),
    ("d 64", (2, 64, 64)),
]
INCLUDE_LINE = re.compile(r'^#include "(\w+\.cuh)"$', re.M)


def inline_header(source: str, header: str, name: str = HEADER) -> str:
    """``source`` with its include of the header ``name`` replaced by
    ``header``'s text (its ``#pragma once`` dropped)."""
    include = f'#include "{name}"'
    lines = source.split("\n")
    hits = [i for i, ln in enumerate(lines) if ln.strip() == include]
    if len(hits) != 1:
        raise ValueError(f"the source includes {name} {len(hits)} times, not once")
    body = "\n".join(ln for ln in header.split("\n") if ln.strip() != "#pragma once")
    return "\n".join(lines[:hits[0]] + [body] + lines[hits[0] + 1:])


def parse_source(spec: str) -> Tuple[str, Path]:
    """``LABEL=PATH.cu`` -> (label, path); the label may not be "this"."""
    label, sep, path = spec.partition("=")
    if not sep or not label or not path.endswith(".cu"):
        raise ValueError(f"--source takes LABEL=PATH.cu, got {spec!r}")
    if label in ("this", "phases"):
        raise ValueError(f'"{label}" names a build of the checkout\'s sources')
    return label, Path(path)


def inline_headers(source_cu: Path) -> str:
    """The text of ``source_cu`` with each of its header includes replaced
    by the header beside it (the headers include no other)."""
    text = source_cu.read_text()
    for name in INCLUDE_LINE.findall(text):
        text = inline_header(text, (source_cu.parent / name).read_text(), name)
    return text


def variant_sources(text_cu: Path) -> Dict[str, str]:
    """The self-contained sources of one variant, by library name:
    ``fused_text_layer`` always, ``fused_rect_layer`` where it lies beside."""
    out = {"fused_text_layer": inline_headers(text_cu)}
    rect = text_cu.parent / "fused_rect_layer.cu"
    if rect.exists():
        out["fused_rect_layer"] = inline_headers(rect)
    return out


def build_variants(variants: Dict[str, Dict[str, str]]) -> Dict[str, Dict[str, ctypes.CDLL]]:
    """Every source of every variant built into its own library, all nvcc
    runs at once; each kernel's ptxas registers, spills and shared bytes
    printed per variant."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for label, sources in variants.items():
        for name, text in sources.items():
            digest = hashlib.sha256((text + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:12]
            src, lib = out_dir / f"{name}-{digest}.cu", out_dir / f"lib{name}-{digest}.so"
            src.write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs[label, name] = (proc, lib)
    libs: Dict[str, Dict[str, ctypes.CDLL]] = {}
    for (label, name), (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {label} {name}: nvcc exit {proc.returncode}\n{log}")
        kernel = ""
        for ln in log.splitlines():
            m = re.search(r"entry function '(\w+?)'", ln)
            if m:
                kernel = m.group(1)
            elif kernel and any(w in ln for w in ("spill", "registers")):
                print(f"ptxas {label} {name} {kernel}: {ln.split(':', 1)[-1].strip()}")
        libs.setdefault(label, {})[name] = ctypes.CDLL(str(lib))
    return libs


def use(libs: Dict[str, ctypes.CDLL]) -> None:
    """Make the wrappers launch from ``libs``."""
    for name, lib in libs.items():
        _build._loaded[name] = lib
    ftl._lib()  # each sets its argument types
    if "fused_rect_layer" in libs:
        frl._lib()


def shapes(gen: torch.Generator, rect: bool):
    """(label, kernel name, call, plain call) per shape; the calls run
    under torch.no_grad()."""
    for label, (N, L, d, heads) in TEXT_SHAPES:
        blk = ftl.with_kernel_layout(random_block(gen, d))
        x = torch.randn(N, L, d, generator=gen, device="cuda").to(torch.bfloat16)
        i = torch.arange(L, device="cuda")
        causal = torch.where(i[None, :] > i[:, None], -1e9, 0.0).float()
        yield (f"fused_text_layer {label} {(N, L, d)} {heads} heads", "fused_text_layer",
               lambda x=x, b=blk, h=heads, m=causal: ftl.fused_text_layer(x, b, h, m),
               lambda x=x, b=blk, h=heads, m=causal: ftl.fused_text_layer_reference(x, b, h, m))
    if not rect:
        return
    B, L, d, heads, n_kv = RECT_SHAPE
    blk = ftl.with_kernel_layout(random_block(gen, d))
    x = torch.randn(B, L, d, generator=gen, device="cuda").to(torch.bfloat16)
    yield (f"fused_rect_attn_half {(B, L, d)} n_kv {n_kv} {heads} heads", "fused_rect_layer",
           lambda: frl.fused_rect_attn_half(x, blk["ln_1"], blk["attn"], heads, n_kv,
                                            kernel=blk["kernel"]),
           lambda: frl.fused_rect_attn_half_reference(x, blk["ln_1"], blk["attn"], heads, n_kv))
    for label, (B, L, d) in MLP_SHAPES:
        if d != blk["ln_2"]["scale"].shape[0]:
            blk = ftl.with_kernel_layout(random_block(gen, d))
        x = torch.randn(B, L, d, generator=gen, device="cuda").to(torch.bfloat16)
        yield (f"fused_mlp_half {label} {(B, L, d)}", "fused_rect_layer",
               lambda x=x, b=blk: frl.fused_mlp_half(x, b["ln_2"], b["mlp"], kernel=b["kernel"]),
               lambda x=x, b=blk: frl.fused_mlp_half_reference(x, b["ln_2"], b["mlp"]))


PHASES = ("set-up and LN1", "q/k/v products", "attention", "out projection", "LN2",
          "fc products", "QuickGELU", "proj products", "MLP epilogue")
# clocks inside those phases
EXTRAS = ("ring wait and barrier, within the products", "scores, within the attention",
          "softmax, within the attention")


def phase_clocks(lib: ctypes.CDLL, smi: str) -> List[dict]:
    """The phase-clock build at the CoCoOp chunk: one reading per phase."""
    N, L, d, heads = TEXT_SHAPES[0][1]
    gen = torch.Generator(device="cuda").manual_seed(1)
    blk = ftl.with_kernel_layout(random_block(gen, d))
    x = torch.randn(N, L, d, generator=gen, device="cuda").to(torch.bfloat16)
    i = torch.arange(L, device="cuda")
    causal = torch.where(i[None, :] > i[:, None], -1e9, 0.0).float()
    scratch = torch.empty((N * L + ftl._SCRATCH_ROWS, d), dtype=x.dtype, device="cuda")
    use({"fused_text_layer": lib})
    with torch.no_grad():
        fn = lambda: ftl._launch(x, blk, heads, causal, 1e-5, scratch=scratch)  # noqa: E731
        ms = device_ms(fn, N_CALLS)
        fn()
        torch.cuda.synchronize()
    tail = scratch[N * L:].contiguous().view(torch.int64).flatten()
    clocks = tail[:len(PHASES)].tolist()
    extras = tail[len(PHASES):len(PHASES) + len(EXTRAS)].tolist()
    total = sum(clocks)
    out = []
    for name, c in zip(PHASES, clocks):
        share = c / total if total else 0.0
        out.append({"phase": name, "clocks": c, "share": share,
                    "device_ms": None if ms is None else share * ms})
        print(f"phase {name} {(N, L, d)} on {smi}: {c} clocks of block 0, {share:.1%}, "
              f"{fmt_ms(out[-1]['device_ms'])} of {fmt_ms(ms)}", flush=True)
    for name, c in zip(EXTRAS, extras):
        out.append({"phase": name, "clocks": c, "share": c / total if total else 0.0})
        print(f"phase {name}: {c} clocks of block 0, {out[-1]['share']:.1%}", flush=True)
    return out


def differences(out: torch.Tensor, other: torch.Tensor) -> Tuple[int, float]:
    """(elements that differ, largest absolute difference) of two outputs."""
    diff = (out.float() - other.float()).abs()
    return int((out != other).sum()), diff.max().item()


def worst_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest error over its tolerance, 2e-2 x max(|plain|, 1)."""
    diff = (out.float() - ref.float()).abs()
    return (diff / (TOL * ref.float().abs().clamp(min=1.0))).max().item()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", type=Path)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)
    specs = [parse_source(s) for s in args.source]
    if not torch.cuda.is_available():
        print("time_fused needs a CUDA card; none is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {"this": variant_sources(_build.CSRC / "fused_text_layer.cu")}
    for label, path in specs:
        variants[label] = variant_sources(path)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"time_fused on {smi}, torch {torch.__version__} cuda {torch.version.cuda}; "
          f"variants {list(variants)}", flush=True)
    if args.phases:
        variants["phases"] = {"fused_text_layer": "#define FUSED_TEXT_PHASES\n"
                              + variants["this"]["fused_text_layer"]}
    libs = build_variants(variants)
    phase_lib = libs.pop("phases", {}).get("fused_text_layer")
    use(libs["this"])
    for label, (N, L, d, heads) in TEXT_SHAPES:
        print(f"plan this {(N, L, d)} {heads} heads: {ftl.launch_plan(N, L, d, heads)}",
              flush=True)
    print(f"plan this fused_rect_attn_half {RECT_SHAPE}: {frl.attn_launch_plan(*RECT_SHAPE)}",
          flush=True)
    for label, (B, L, d) in MLP_SHAPES:
        print(f"plan this fused_mlp_half {(B, L, d)}: {frl.mlp_launch_plan(B * L, d)}",
              flush=True)
    rect_ok = all("fused_rect_layer" in v for v in libs.values())
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings, failed = [], False
    with torch.no_grad():
        for label, name, kernel, plain in shapes(gen, rect_ok):
            ref = plain()
            outs = {}
            for v, vlibs in libs.items():
                use(vlibs)
                outs[v] = kernel()
                worst = worst_error(outs[v], ref)
                equal = torch.equal(outs[v], outs["this"])
                n_diff, max_diff = differences(outs[v], outs["this"])
                print(f"{label} {v}: torch.equal to this {equal} ({n_diff} of "
                      f"{outs[v].numel()} elements differ, by at most {max_diff:.3e}), max err "
                      f"/ tol against the plain version {worst:.3f}", flush=True)
                if not (worst <= 1 and bool(torch.isfinite(outs[v]).all())):
                    print(f"FAIL: {label} {v} disagrees with the plain version", flush=True)
                    failed = True
            del outs, ref
            for r in range(args.rounds):
                for v in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                    use(libs[v])
                    reading = {"shape": label, "variant": v, "round": r,
                               "call_ms": call_ms(kernel, N_CALLS),
                               "stream_ms": stream_ms(kernel, N_CALLS)}
                    # the device time last, after 60 calls, as it always was
                    split = reading["device_ms_by_kernel"] = device_ms_by_kernel(kernel,
                                                                                 N_CALLS)
                    reading["device_ms"] = None if split is None else sum(split.values())
                    readings.append(reading)
                    print(f"{label} {v} round {r} on {smi}: call {reading['call_ms']:.4f} ms, "
                          f"stream {reading['stream_ms']:.4f} ms, device "
                          f"{fmt_ms(reading['device_ms'])}", flush=True)
                    if split and len(split) > 1:  # the rect-layer halves' launches
                        for k, ms in sorted(split.items(), key=lambda kv: -kv[1]):
                            print(f"  {label} {v} round {r}: device {ms:.4f} ms in {k}",
                                  flush=True)
    phases = phase_clocks(phase_lib, smi) if phase_lib is not None else []
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": smi, "readings": readings, "phases": phases},
                                        indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
