"""Time builds of ``ops/csrc/rect_attention.cu`` side by side, in one
process, at the bf16 attention kernels' main-path shapes.

    python3 -m rpo_tpu_torch.tools.time_attention \\
        [--source LABEL=PATH.cu ...] [--d64-widths LABEL=W,W,... ...] \\
        [--rounds 2] [--json PATH]

The variants: "this", the checkout's source; each ``--source``, another
source with the same C entry points (an earlier commit's, written out
with ``git show``); each ``--d64-widths``, the checkout's source with the
score widths (16-column tiles) of its D = 64 bf16 instantiations cut to
the set given, a shape taking the narrowest that holds its tiles (the set
must hold 16, the widest row, which the two-pass route needs).  All are
built at once with the package's nvcc flags and run under the same
wrappers (``ops/rect_attention.py``, ``ops/masked_attention.py``).

The shapes: rect (100, 12, 221, 197, 64) in the eval tower's layout,
(100, 12, 197, 197, 64) as the square towers hand it over, and masked
(51, 8, L, L, 64) with the shared causal bias at L = 77, 24 and 16.  At
each shape every variant is first held to the plain version (2e-2) and
compared with the checkout's build (``torch.equal``), then the variants
and SDPA are timed in order and in reverse, ``--rounds``
times in all, on the three timers of ``timing``.  One line per reading,
with the card's name and power limit; ``--json`` writes them all.
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
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops import masked_attention as ma
from ..ops import rect_attention as ra
from .timing import call_ms, device_ms, fmt_ms, stream_ms

NEG_INF = -1e9
TOL = 2e-2
N_CALLS = 30


def with_d64_widths(source: str, widths: Sequence[int]) -> str:
    """``source`` with the D = 64 case of ``dispatch_bf16`` launching the
    narrowest of ``widths`` (score tiles) that holds a shape's tiles."""
    widths = sorted(set(widths))
    if not widths or widths[0] < 1 or widths[-1] != 16:
        raise ValueError(f"widths {widths} must lie in 1..16 and hold 16")
    start = source.index("    case 64:\n", source.index("int dispatch_bf16("))
    end = source.index("    case 128:", start)
    launch = "launch_tc<64, HAS_BIAS, {}>(p, B, H, dev, max_smem, s)"
    expr = launch.format(widths[-1])
    for w in reversed(widths[:-1]):
        expr = f"nkt <= {w} ? {launch.format(w)}\n             : {expr}"
    return source[:start] + f"    case 64:\n      return {expr};\n" + source[end:]


def build_variants(sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Each source built into its own library, all nvcc runs at once; the
    ptxas lines of the attention kernels printed per variant."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)]
    jobs = {}
    for label, text in sources.items():
        digest = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()[:12]
        src, lib = out_dir / f"rect_attention-{digest}.cu", out_dir / f"lib{digest}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *flags, "-o", str(lib), str(src)]
        jobs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for label, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {label}: nvcc exit {proc.returncode}\n{log}")
        name = ""
        for ln in log.splitlines():
            m = re.search(r"entry function '.*?(attention_kernel\w*?I\w+?E)Ev", ln)
            if m:
                name = m.group(1)
            elif name and ("spill" in ln or "registers" in ln):
                print(f"ptxas {label} {name}: {ln.split(':', 1)[-1].strip()}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def use(lib: ctypes.CDLL) -> None:
    """Make the wrappers launch from ``lib``."""
    _build._loaded["rect_attention"] = lib
    ra._lib()  # sets its argument types


def shapes(gen: torch.Generator):
    """(label, kernel call, plain call, SDPA call, (q, k, v)) per shape."""
    def heads(x, B, L, n, H, D):  # head views of a (B, L, n*H*D) projection output
        return x.view(B, L, n, H, D).permute(2, 0, 3, 1, 4)

    bf16 = torch.bfloat16
    B, H, Lq, Lk, D = 100, 12, 221, 197, 64
    q = heads(torch.randn(B, Lq, H * D, generator=gen, device="cuda").to(bf16), B, Lq, 1, H, D)[0]
    k, v = heads(torch.randn(B, Lk, 2 * H * D, generator=gen, device="cuda").to(bf16),
                 B, Lk, 2, H, D)
    out = [("rect (100,12,221,197,64)", (q, k, v), None)]
    q, k, v = heads(torch.randn(B, Lk, 3 * H * D, generator=gen, device="cuda").to(bf16),
                    B, Lk, 3, H, D)
    out.append(("rect (100,12,197,197,64)", (q, k, v), None))
    B, H = 51, 8
    for L in (77, 24, 16):
        q, k, v = heads(torch.randn(B, L, 3 * H * D, generator=gen, device="cuda").to(bf16),
                        B, L, 3, H, D)
        i = torch.arange(L, device="cuda")
        bias = torch.where(i[None, :] > i[:, None], NEG_INF, 0.0)[None, None].float()
        out.append((f"masked (51,8,{L},{L},64) shared causal", (q, k, v), bias))
    for label, qkv, bias in out:
        if bias is None:
            yield (label, lambda qkv=qkv: ra.rect_attention(*qkv),
                   lambda qkv=qkv: ra.rect_attention_reference(*qkv),
                   lambda qkv=qkv: F.scaled_dot_product_attention(*qkv))
        else:
            bias_q = bias.to(bf16)  # SDPA takes a float mask in q's dtype
            yield (label, lambda qkv=qkv, b=bias: ma.masked_attention(*qkv, b),
                   lambda qkv=qkv, b=bias: ma.masked_attention_reference(*qkv, b),
                   lambda qkv=qkv, b=bias_q: F.scaled_dot_product_attention(*qkv, attn_mask=b))


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH.cu")
    ap.add_argument("--d64-widths", action="append", default=[], metavar="LABEL=W,W,...")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attention needs a CUDA card; none is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    this = (_build.CSRC / "rect_attention.cu").read_text()
    sources = {"this": this}
    for spec in args.source:
        label, path = spec.split("=", 1)
        sources[label] = Path(path).read_text()
    for spec in args.d64_widths:
        label, widths = spec.split("=", 1)
        sources[label] = with_d64_widths(this, [int(w) for w in widths.split(",")])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"time_attention on {smi}, torch {torch.__version__} cuda {torch.version.cuda}; "
          f"variants {list(sources)}", flush=True)
    libs = build_variants(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings = []
    for label, kernel, plain, sdpa in shapes(gen):
        ref = plain().float()
        outs = {}
        for name, lib in libs.items():
            use(lib)
            outs[name] = kernel()
            err = (outs[name].float() - ref).abs().max().item()
            print(f"{label} {name}: max_abs_err {err:.3e} (tol {TOL:g}), torch.equal to this "
                  f"{torch.equal(outs[name], outs['this'])}", flush=True)
            if not err <= TOL:
                print(f"FAIL: {label} {name} disagrees with the plain version", flush=True)
                return 1
        del outs
        order = list(libs) + ["SDPA"]
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                fn = sdpa if name == "SDPA" else kernel
                if name != "SDPA":
                    use(libs[name])
                reading = {"shape": label, "variant": name, "round": r,
                           "call_ms": call_ms(fn, N_CALLS), "stream_ms": stream_ms(fn, N_CALLS),
                           "device_ms": device_ms(fn, N_CALLS)}
                readings.append(reading)
                print(f"{label} {name} round {r}: call {reading['call_ms']:.4f} ms, stream "
                      f"{reading['stream_ms']:.4f} ms, device {fmt_ms(reading['device_ms'])}",
                      flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": smi, "readings": readings}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
