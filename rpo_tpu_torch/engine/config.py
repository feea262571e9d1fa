"""Layered config system: yacs-compatible semantics, zero dependencies.

A copy of ``rpo_tpu/engine/config.py`` (the reference's merge pipeline:
defaults -> dataset yaml -> trainer yaml -> CLI flags -> dotted KV
overrides -> freeze; strings that parse as Python literals, such as
``SIZE: (224, 224)``, are literal-eval'd as yacs' ``_decode_cfg_value``
does) with the same default tree, every key and value alike.

PyYAML is not a dependency: ``read_yaml`` reads the subset of YAML that
the repository's config files use, with PyYAML's ``safe_load`` (YAML 1.1)
types, and refuses any other construct.
"""
from __future__ import annotations

import ast
import copy
import re
from typing import Any, Dict, List, Tuple

# PyYAML's implicit resolvers (YAML 1.1): ``1e-5`` has no dot and so stays
# a string, which ``_decode`` then turns into a float
_NULL = re.compile(r"^(?:~|null|Null|NULL)$")
_BOOL = {w: v for v, words in ((True, "yes Yes YES true True TRUE on On ON"),
                               (False, "no No NO false False FALSE off Off OFF"))
         for w in words.split()}
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# indicators a plain scalar may not start with, and the constructs read_yaml
# leaves out (block sequences, flow mappings, anchors, tags, block scalars)
_UNSUPPORTED = re.compile(r"^(?:[][{}&*!|>%@`,]|[-?:](?:\s|$))")
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}


def _plain(text: str, where: str) -> Any:
    """A plain scalar resolved to PyYAML's type."""
    if _UNSUPPORTED.match(text) or ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: unsupported YAML construct {text!r}")
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if len(digits) > 1 and digits[0] == "0":
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(text):
        digits = text.replace("_", "").lower()
        if digits.endswith("nan"):
            return float("nan")
        return float(digits.replace(".inf", "inf"))
    return text


def _quoted(text: str, where: str) -> Tuple[str, str]:
    """A quoted scalar at the start of ``text``: (its value, the rest)."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":  # '' is a quote inside single quotes
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if quote == '"' and c == '"':
            return "".join(out), text[i + 1:]
        if quote == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise ValueError(f"{where}: unsupported escape \\{esc} in {text!r}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    raise ValueError(f"{where}: unterminated quoted scalar {text!r}")


def _value(text: str, where: str) -> Any:
    """The value after ``KEY:``: a quoted or plain scalar or a flow list of
    scalars."""
    if text[0] in "'\"":
        value, rest = _quoted(text, where)
        if rest.strip():
            raise ValueError(f"{where}: text after a quoted scalar: {text!r}")
        return value
    if text[0] != "[":
        return _plain(text, where)
    if not text.endswith("]"):
        raise ValueError(f"{where}: unsupported flow sequence {text!r}")
    items, rest = [], text[1:-1].strip()
    while rest:
        if rest[0] in "'\"":
            value, rest = _quoted(rest, where)
        else:
            plain, _, rest = rest.partition(",")
            if not plain.strip() or plain.strip()[0] in "[{":
                raise ValueError(f"{where}: unsupported flow sequence {text!r}")
            items.append(_plain(plain.strip(), where))
            rest = rest.strip()
            continue
        items.append(value)
        rest = rest.strip()
        if rest and not rest.startswith(","):
            raise ValueError(f"{where}: text after a quoted item in {text!r}")
        rest = rest[1:].strip()
    return items


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(text: str) -> Any:
    """Parse the YAML subset of the repository's config files: nested block
    mappings by indentation (spaces), comments, quoted and plain scalars
    and flow lists of scalars, typed as PyYAML's ``safe_load`` types them.
    Any other construct raises ``ValueError``.  An empty document is None."""
    root: Dict[str, Any] = {}
    stack: List[Tuple[int, Dict[str, Any]]] = []
    pending = None  # (indent, mapping, key) of a ``KEY:`` awaiting its block
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        line = _strip_comment(raw).rstrip()
        body = line.lstrip(" ")
        if not body or (body == "---" and not stack):
            continue
        if body.startswith("\t") or body == "...":
            raise ValueError(f"{where}: unsupported YAML construct {raw!r}")
        indent = len(line) - len(body)
        if not stack:
            stack.append((indent, root))
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:
                p_map[p_key] = {}
                stack.append((indent, p_map[p_key]))
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"{where}: inconsistent indentation")
        match = re.match(r"^([^'\"\s][^:]*?)\s*:(?:\s+(.*))?$", body)
        if match is None or _UNSUPPORTED.match(body):
            raise ValueError(f"{where}: unsupported YAML construct {raw!r}")
        key, rest = _plain(match.group(1), where), match.group(2)
        mapping = stack[-1][1]
        if rest:
            mapping[key] = _value(rest, where)
        else:
            mapping[key] = None
            pending = (indent, mapping, key)
    return root if stack else None


class CfgNode(dict):
    """Attribute-accessible dict with freeze semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init: Dict | None = None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Non-existent config key: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"Attempted to set {name} on a frozen CfgNode")
        self[name] = value

    # -- freeze -------------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, value: bool) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # -- merging ------------------------------------------------------------
    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            loaded = read_yaml(f.read()) or {}
        self._merge_dict(loaded, path)

    def merge_from_list(self, kv_list: List[str]) -> None:
        """Dotted KEY VALUE pairs, e.g. ["DATASET.NUM_SHOTS", "16"]."""
        if self.is_frozen():
            # same contract as _merge_dict / yacs: mutating a frozen cfg
            # must fail at the mutation site, not corrupt derived state
            raise AttributeError("Attempted to merge into a frozen CfgNode")
        if not kv_list:
            return
        assert len(kv_list) % 2 == 0, f"Override list has odd length: {kv_list}"
        for key, value in zip(kv_list[0::2], kv_list[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(_decode(value), node[leaf], key)

    def _merge_dict(self, d: Dict, origin: str) -> None:
        if self.is_frozen():
            raise AttributeError("Attempted to merge into a frozen CfgNode")
        for k, v in d.items():
            if k not in self:
                # yacs raises on unknown keys; keep that contract to catch typos
                raise KeyError(f"Non-existent config key: {k} (from {origin})")
            existing = self[k]
            if isinstance(v, dict) and isinstance(existing, CfgNode):
                existing._merge_dict(v, origin)
            else:
                self[k] = _coerce(_decode(v), existing, k)

    # -- printing -----------------------------------------------------------
    def __str__(self) -> str:
        lines: List[str] = []
        for k in sorted(self.keys()):
            v = self[k]
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.extend("  " + ln for ln in str(v).split("\n"))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"CfgNode({super().__repr__()})"


def _decode(value: Any) -> Any:
    """Strings that parse as Python literals become literals (yacs rule)."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(new: Any, old: Any, key: str) -> Any:
    if old is None:
        return new
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if type(new) == type(old):
        return new
    if isinstance(old, float) and isinstance(new, int) and not isinstance(new, bool):
        return float(new)
    if isinstance(old, str) and new is not None:
        # the CLI literal_eval round-trip can turn a numeric-looking string
        # back into a literal; a str default restores it
        return str(new)
    if isinstance(old, bool) != isinstance(new, bool) and {type(old), type(new)} <= {
        bool,
        int,
    }:
        return type(old)(new)
    # Everything else is a type error at the merge site (yacs semantics):
    # a float onto an int default (e.g. BATCH_SIZE 64.5) or None onto a
    # typed default must fail HERE, not deep in the loader/trainer.
    raise ValueError(
        f"Type mismatch for key {key}: cannot replace {type(old).__name__} "
        f"({old!r}) with {type(new).__name__} ({new!r})"
    )


def get_cfg_default() -> CfgNode:
    """Default config tree: the Dassl surface the reference consumes
    (SURVEY.md §2.9) + extend_cfg extras (train.py:82-119)."""
    cfg = CfgNode(
        {
            "VERSION": 1,
            "OUTPUT_DIR": "./output",
            "RESUME": "",
            "SEED": -1,
            "USE_CUDA": True,  # kept for CLI compat; means "use accelerator"
            "VERBOSE": True,
            "DATASET": {
                "ROOT": "",
                "NAME": "",
                "SOURCE_DOMAINS": (),
                "TARGET_DOMAINS": (),
                "NUM_SHOTS": -1,
                "VAL_PERCENT": 0.1,
                "SUBSAMPLE_CLASSES": "all",  # all, base or new
                "PROMPT": "a photo of a _.",
            },
            "DATALOADER": {
                "NUM_WORKERS": 4,
                "K_TRANSFORMS": 1,
                "RETURN_IMG0": False,
                "TRAIN_X": {
                    "SAMPLER": "RandomSampler",
                    "BATCH_SIZE": 32,
                    "N_DOMAIN": 0,
                    "N_INS": 16,
                },
                "TEST": {"SAMPLER": "SequentialSampler", "BATCH_SIZE": 32},
            },
            "INPUT": {
                "SIZE": (224, 224),
                "INTERPOLATION": "bilinear",
                "TRANSFORMS": (),
                "NO_TRANSFORM": False,
                "PIXEL_MEAN": [0.485, 0.456, 0.406],
                "PIXEL_STD": [0.229, 0.224, 0.225],
                "CROP_PADDING": 4,
                "RRCROP_SCALE": (0.08, 1.0),
                # TPU-native extension (not in Dassl): when > 0, batches
                # carry raw fixed-size source images of this side length
                # (e.g. 64 for EuroSAT) and preprocessing runs ON DEVICE
                # inside the jitted steps (ops/preprocess.py) — 12x less
                # host->device traffic.  Eval: bicubic resize+crop+
                # normalize.  Train: the host samples the RandomResizedCrop
                # box/flip (in source coords) and the device builds the
                # per-image bicubic resample weights and applies
                # crop+resize+flip+normalize (device_train_preprocess).
                "DEVICE_RESIZE": 0,
            },
            "MODEL": {
                "INIT_WEIGHTS": "",
                "BACKBONE": {"NAME": "", "PRETRAINED": True},
                "HEAD": {"NAME": ""},
            },
            "OPTIM": {
                "NAME": "sgd",
                "LR": 0.0003,
                "WEIGHT_DECAY": 5e-4,
                "MOMENTUM": 0.9,
                "SGD_DAMPNING": 0.0,
                "SGD_NESTEROV": False,
                "ADAM_BETA1": 0.9,
                "ADAM_BETA2": 0.999,
                "MAX_EPOCH": 10,
                "LR_SCHEDULER": "single_step",
                "STEPSIZE": (-1,),
                "GAMMA": 0.1,
                "WARMUP_EPOCH": -1,
                "WARMUP_TYPE": "linear",
                "WARMUP_CONS_LR": 1e-5,
                "WARMUP_MIN_LR": 1e-5,
                "WARMUP_RECOUNT": True,
            },
            "TRAIN": {
                "CHECKPOINT_FREQ": 0,
                "PRINT_FREQ": 10,
                "COUNT_ITER": "train_x",
                # TPU-native observability (SURVEY.md §5): jax.profiler
                # trace capture for the given epoch into PROFILE_DIR, and
                # a NaN detector equivalent to the reference's
                # torch.autograd.set_detect_anomaly (train.py:287-288).
                "PROFILE_DIR": "",
                "PROFILE_EPOCH": 1,
                "DEBUG_NANS": False,
                # Fuse N optimizer steps into one jitted dispatch
                # (lax.scan over the batch-group axis).  Numerically
                # identical sequential SGD; amortizes per-step host->device
                # round trips.  1 = off (default): with the async dispatch
                # queue + device_prefetch the grouped program gains only
                # ~1% steady-state but costs ~100s of extra XLA compile on
                # this TPU backend (measured cold 16-shot CLI: 116s at
                # G=1 vs 189s at G=8).  Raise for long runs where the
                # compile amortizes.
                "STEPS_PER_DISPATCH": 1,
                # Tensor parallelism: split the tower math itself over a
                # "model" mesh axis of this size (devices = dp x tp;
                # parallel/tp.py).  0/1 = off (default).  DP alone covers
                # every throughput-bound workload here — reach for this
                # only in the latency-bound regime (batch < n_devices).
                "TENSOR_PARALLEL": 0,
                # AOT-compile train/eval programs on background threads at
                # build time, overlapping XLA compilation with the data
                # pipeline (the reference has no compile step; this hides
                # most of ours).  Non-fatal if a prewarm fails.
                "PREWARM_COMPILE": True,
                # Compute the train-step forward/backward in microbatches of
                # this size (unrolled chunk loop inside ONE loss/grad; the
                # optimizer still sees the full-batch gradient — identical
                # math, one SGD step).  Fixes the XLA layout regression at
                # large batch: at B=128 the monolithic tower scan flips to a
                # {2,0,1} activation layout and burns ~17ms/step in layout
                # copies (1500 img/s); MICROBATCH=32 keeps each tower call at
                # the B=32 shape XLA lays out well (1919 img/s measured,
                # BASELINE.md r4 batch table).  0 = off (default).  Applies
                # when 0 < MICROBATCH < batch and batch % MICROBATCH == 0.
                # Wired for every standard-CE-step trainer sharing the
                # scanned frozen vision tower the cliff lives in: RPO
                # (1500 -> 1927 at B=128), CoOp (2920 -> 3639), LP
                # (BASELINE.md r4/r5 batch tables); CoCoOp large batches
                # use exact gradient accumulation instead (automatic).
                # Composes with a pure data-parallel mesh (the chunked
                # step runs per-device under shard_map, grads psum'd);
                # ignored (loudly) under dp x tp, where the tp program
                # shards the tower math itself.
                "MICROBATCH": 0,
            },
            "TEST": {
                "EVALUATOR": "Classification",
                "PER_CLASS_RESULT": False,
                "COMPUTE_CMAT": False,
                "NO_TEST": False,
                "SPLIT": "test",
                "FINAL_MODEL": "last_step",
            },
            "TRAINER": {
                "NAME": "",
                # extend_cfg (train.py:95-119)
                "RPO": {"K": 1, "CTX_INIT": "", "PREC": "fp16"},
                "COCOOP": {"N_CTX": 4, "CTX_INIT": "a photo of a", "PREC": "fp16"},
                "COOP": {
                    "N_CTX": 4,
                    "CSC": False,
                    "CLASS_TOKEN_POSITION": "",
                    "PREC": "fp16",
                    "CTX_INIT": "",
                },
                "LP": {"PREC": "fp16", "PROMPT": "A photo of a {cls_name}"},
            },
        }
    )
    return cfg
