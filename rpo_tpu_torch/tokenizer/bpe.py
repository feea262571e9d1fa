"""Byte-level BPE tokenizer compatible with the CLIP tokenizer.

A copy of ``rpo_tpu/tokenizer/bpe.py`` (the port imports nothing of the
JAX package).  It needs only numpy, ``regex`` and gzip.  The merge table
is the public OpenAI CLIP vocabulary data file
(``bpe_simple_vocab_16e6.txt.gz``, copied beside this module); the
tokens must match the CLIP tokenizer bit for bit because the frozen CLIP
text tower was trained against them.  Tokenization runs on the host once
per task; the device never sees strings.
"""
from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import regex as re

try:  # ftfy is optional; classnames/templates are ASCII where it is a no-op.
    import ftfy

    def _fix_text(text: str) -> str:
        return ftfy.fix_text(text)
except Exception:  # pragma: no cover - exercised only when ftfy is absent

    def _fix_text(text: str) -> str:
        # Minimal stand-in: ftfy.fix_text is the identity on well-formed
        # text; normalize NFC like ftfy does by default.
        return unicodedata.normalize("NFC", text)


VOCAB_SIZE = 49408
SOT_TOKEN = 49406
EOT_TOKEN = 49407
CONTEXT_LENGTH = 77

_WORD_END = "</w>"


@lru_cache()
def default_bpe_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """Invertible map from the 256 byte values to printable unicode chars.

    Printable bytes map to themselves; the rest are displaced to 256+n.
    Must produce the identical table to GPT-2/CLIP for vocab compatibility.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping: Dict[int, str] = {b: chr(b) for b in keep}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


def clean_text(text: str) -> str:
    """basic_clean + whitespace_clean of the reference, fused."""
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.strip()


class ClipTokenizer:
    """CLIP-compatible byte-level BPE encoder/decoder."""

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or default_bpe_path()
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # Same slice as the reference: skip header line, keep exactly
        # 49152-256-2 merge rules (as the CLIP tokenizer does).
        n_merges = VOCAB_SIZE - 512 - 2
        merge_rules: List[Tuple[str, str]] = []
        for line in lines[1 : 1 + n_merges]:
            a, b = line.split()
            merge_rules.append((a, b))
        self.merge_rank: Dict[Tuple[str, str], int] = {
            pair: rank for rank, pair in enumerate(merge_rules)
        }

        base = list(byte_to_unicode().values())
        tokens = base + [c + _WORD_END for c in base]
        tokens += ["".join(pair) for pair in merge_rules]
        tokens += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(tokens)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        assert len(self.encoder) == VOCAB_SIZE

        self._bpe_cache: Dict[str, Tuple[str, ...]] = {}
        self.word_pattern = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )

    # -- BPE ---------------------------------------------------------------
    def _merge_word(self, token: str) -> Tuple[str, ...]:
        """Apply merge rules (lowest rank first) to one unicode-mapped word."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        if token in ("<|startoftext|>", "<|endoftext|>"):
            return (token,)

        parts: List[str] = list(token[:-1]) + [token[-1] + _WORD_END]
        if len(parts) == 1:
            result = tuple(parts)
            self._bpe_cache[token] = result
            return result

        while len(parts) > 1:
            # Find the adjacent pair with the lowest merge rank.
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                rank = self.merge_rank.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_idx = i
            if best_rank is None:
                break
            first, second = parts[best_idx], parts[best_idx + 1]
            # Merge *every* occurrence of that pair left-to-right, matching
            # the CLIP tokenizer's merge loop.
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    parts[i] == first
                    and i + 1 < len(parts)
                    and parts[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged

        result = tuple(parts)
        self._bpe_cache[token] = result
        return result

    # -- public API --------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = clean_text(text).lower()
        for word in re.findall(self.word_pattern, text):
            mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._merge_word(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace(_WORD_END, " ")


_global_tokenizer: ClipTokenizer | None = None


def get_tokenizer() -> ClipTokenizer:
    global _global_tokenizer
    if _global_tokenizer is None:
        _global_tokenizer = ClipTokenizer()
    return _global_tokenizer


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    """SOT + BPE + EOT, zero-padded to ``context_length``.

    Behaves as ``clip.tokenize``.  Returns an
    int32 numpy array of shape (n_texts, context_length); host-side only.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT_TOKEN] + tok.encode(text) + [EOT_TOKEN]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = ids[: context_length - 1] + [EOT_TOKEN]
        out[i, : len(ids)] = ids
    return out


def eot_len(tokens: np.ndarray, multiple: int = 8) -> int:
    """Truncated sequence length: max(EOT position)+1 rounded up to a
    sublane ``multiple``, clamped to the full length — the single
    definition of the text-tower truncation rule (see eot_trim)."""
    L = int(tokens.argmax(axis=-1).max()) + 1
    return min(tokens.shape[1], -(-L // multiple) * multiple)


def eot_trim(tokens: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Trim padded token rows past the longest EOT (host-side).

    Returns ``tokens[:, :L]`` with L = eot_len(tokens, multiple).  Exact
    for causal-mask encoders that gather only EOT positions (see
    models/clip/model.py::encode_text); CLIP itself always runs the
    full 77."""
    return tokens[:, : eot_len(tokens, multiple)]
