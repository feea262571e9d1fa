from .bpe import (
    CONTEXT_LENGTH,
    EOT_TOKEN,
    SOT_TOKEN,
    VOCAB_SIZE,
    ClipTokenizer,
    eot_trim,
    get_tokenizer,
    tokenize,
)

__all__ = [
    "CONTEXT_LENGTH",
    "EOT_TOKEN",
    "SOT_TOKEN",
    "VOCAB_SIZE",
    "ClipTokenizer",
    "eot_trim",
    "get_tokenizer",
    "tokenize",
]
