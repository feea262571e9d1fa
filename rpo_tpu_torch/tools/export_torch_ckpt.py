"""Export a checkpoint of either package to the reference's torch format.

Port of the JAX package's ``tools/export_torch_ckpt.py``.  The port
already loads the reference's released torch checkpoints
(``engine/trainer.py``'s ``_load_checkpoint_file``); this tool goes the
other way, so that prompts trained here can be evaluated by the original
PyTorch implementation (Dassl's ``load_checkpoint``, then
``load_state_dict``):

    python -m rpo_tpu_torch.tools.export_torch_ckpt \\
        output/.../prompt_learner/model.pth.tar-15 \\
        [-o /path/ref_ckpt/model.pth.tar-15] [--method auto|rpo|coop|cocoop|lp]

The layouts are the importers' in reverse:
  RPO / CoOp : text_prompt / img_prompt / ctx pass through unchanged
  CoCoOp     : meta_net {w1, b1, w2, b2} (x @ w) -> meta_net.linearN.weight
               and .bias (torch's nn.Linear, x @ W.T): transposed
  LP         : {w: (in, out), b} -> {weight: (out, in), bias}: transposed
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def detect_method(sd: dict) -> str:
    keys = set(sd)
    if {"text_prompt", "img_prompt"} <= keys:
        return "rpo"
    if "meta_net" in keys:
        return "cocoop"
    if "ctx" in keys:
        return "coop"
    if {"w", "b"} <= keys:
        return "lp"
    raise ValueError(f"cannot infer method from state keys {sorted(keys)}")


def to_torch_state(sd: dict, method: str) -> dict:
    """The reference's state dict of ``method`` from a checkpoint's state
    (numpy arrays), each tensor its own copy."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    if method in ("rpo", "coop"):
        return {k: t(v) for k, v in sd.items()}
    if method == "cocoop":
        m = sd["meta_net"]
        return {
            "ctx": t(sd["ctx"]),
            "meta_net.linear1.weight": t(m["w1"]).T.contiguous(),
            "meta_net.linear1.bias": t(m["b1"]),
            "meta_net.linear2.weight": t(m["w2"]).T.contiguous(),
            "meta_net.linear2.bias": t(m["b2"]),
        }
    if method == "lp":
        return {"weight": t(sd["w"]).T.contiguous(), "bias": t(sd["b"])}
    raise ValueError(method)


def export(in_path: str, out_path: str, method: str = "auto") -> str:
    """Write ``in_path``'s trainable state to ``out_path`` in the
    reference's torch format; returns the method.  The port's own loader
    reads the input, so a reference file re-exports as it is."""
    from ..engine.trainer import _load_checkpoint_file

    ckpt = _load_checkpoint_file(in_path)
    sd = ckpt["state_dict"]
    if method == "auto":
        method = detect_method(sd)
    payload = {
        "state_dict": to_torch_state(sd, method),
        "epoch": int(ckpt.get("epoch", 0)),
        "val_result": ckpt.get("val_result"),
    }
    tmp = f"{out_path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, out_path)
    return method


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoint", help="a model.pth.tar-<epoch> file of either package")
    ap.add_argument("-o", "--out", default="", help="output path (default: <checkpoint>.torch)")
    ap.add_argument("--method", default="auto", choices=["auto", "rpo", "coop", "cocoop", "lp"])
    args = ap.parse_args(argv)
    out = args.out or args.checkpoint + ".torch"
    method = export(args.checkpoint, out, args.method)
    print(f"exported {args.checkpoint} ({method}) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
