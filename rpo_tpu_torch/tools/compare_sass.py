"""Compare the machine code (SASS) of the CUDA sources with another build
of them, kernel by kernel, whatever the kernels are named.

    python3 -m rpo_tpu_torch.tools.compare_sass --parent DIR [NAME ...]

Each NAME (default: ``rect_attention`` and ``fused_text_layer``) is
compiled twice into a cubin with the package's nvcc flags (``-cubin`` in
place of ``-shared``): the checkout's ``csrc/NAME.cu`` and ``DIR/NAME.cu``
(an earlier commit's, written out with ``git show`` beside its headers),
each against the headers that lie beside it.  ``cuobjdump -sass`` lists
each kernel's instructions; addresses and encodings are dropped, and each
kernel of one build is paired with a kernel of the other whose
instructions are the same.  Prints, per source, the kernels of each build
and how many pair; for a kernel that pairs with none, the closest kernel of
the other build and how many of its instructions differ.  Exits 1 if any
kernel pairs with none.  Needs nvcc and cuobjdump, not a card.
"""
from __future__ import annotations

import argparse
import difflib
import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..ops import _build

FUNCTION = re.compile(r"^\s*Function : (\S+)")
INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")
Kernels = Dict[str, Tuple[str, ...]]


def parse_sass(text: str) -> Kernels:
    """``cuobjdump -sass`` output -> {kernel name: its instructions}, with
    the addresses and encodings dropped."""
    kernels: Dict[str, List[str]] = {}
    current: Optional[List[str]] = None
    for line in text.splitlines():
        m = FUNCTION.match(line)
        if m:
            current = kernels.setdefault(m.group(1), [])
            continue
        m = INSTRUCTION.match(line)
        if m and current is not None:
            current.append(" ".join(m.group(1).split()))
    return {name: tuple(body) for name, body in kernels.items()}


def pair(mine: Kernels, theirs: Kernels) -> Tuple[Dict[str, str], List[str], List[str]]:
    """Pair kernels with the same instructions, one to one: (mine -> theirs,
    mine unpaired, theirs unpaired)."""
    free: Dict[Tuple[str, ...], List[str]] = {}
    for name, body in sorted(theirs.items()):
        free.setdefault(body, []).append(name)
    paired, lone = {}, []
    for name, body in sorted(mine.items()):
        if free.get(body):
            paired[name] = free[body].pop(0)
        else:
            lone.append(name)
    return paired, lone, sorted(n for names in free.values() for n in names)


def closest(body: Tuple[str, ...], others: Kernels) -> Tuple[Optional[str], int]:
    """The kernel of ``others`` nearest to ``body``, and the instructions
    that differ (inserted, deleted or replaced, on either side)."""
    best, best_n = None, None
    for name, other in others.items():
        ops = difflib.SequenceMatcher(None, body, other, autojunk=False).get_opcodes()
        n = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops if tag != "equal")
        if best_n is None or n < best_n:
            best, best_n = name, n
    return best, best_n if best_n is not None else len(body)


def sass(source: Path, out_dir: Path) -> Kernels:
    """The kernels of one source, compiled against the headers beside it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(str(source.resolve()).encode()).hexdigest()[:12]
    cubin = out_dir / f"{source.stem}-{tag}.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    nvcc = _build._nvcc()
    built = subprocess.run([nvcc, "-cubin", *flags, "-I", str(source.parent), "-o", str(cubin),
                            str(source)], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{built.stdout}{built.stderr}")
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    return parse_sass(text)


def compare(name: str, parent: Path) -> bool:
    """Print how one source's kernels pair with the parent's; True if all do."""
    out_dir = _build.BUILD_DIR / "sass"
    mine = sass(_build.CSRC / f"{name}.cu", out_dir)
    theirs = sass(parent / f"{name}.cu", out_dir)
    paired, lone, lone_theirs = pair(mine, theirs)
    print(f"sass {name}.cu: {len(mine)} kernels here, {len(theirs)} in {parent}; "
          f"{len(paired)} the same instruction for instruction ({sum(map(len, mine.values()))} "
          f"instructions here, {sum(map(len, theirs.values()))} there)", flush=True)
    for kernels, others, names, where in ((mine, theirs, lone, "here"),
                                         (theirs, mine, lone_theirs, "there")):
        for n in names:
            other, diff = closest(kernels[n], others)
            print(f"  unpaired {where}: {n} ({len(kernels[n])} instructions); closest {other}, "
                  f"{diff} differ", flush=True)
    return not lone and not lone_theirs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("names", nargs="*", default=["rect_attention", "fused_text_layer"])
    args = ap.parse_args(argv)
    ok = [compare(name, args.parent) for name in args.names]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
