"""The port's tokenizer copy against rpo_tpu.tokenizer."""
import numpy as np
import pytest

from rpo_tpu.data.datasets.synthetic import _CLASSNAMES as SYNTHETIC_CLASSNAMES
from rpo_tpu.methods.templates import CUSTOM_TEMPLATES, IMAGENET_TEMPLATES
from rpo_tpu.tokenizer import tokenize as jax_tokenize
from rpo_tpu_torch import tokenizer as port

CLASSNAMES = list(SYNTHETIC_CLASSNAMES) + [
    "Faces_easy", "airplane", "Boeing 737-800", "2012 Tesla Model S", "Abyssinian",
    "apple_pie", "banded", "AnnualCrop", "Apply_Eye_Makeup", "jack-o'-lantern",
    "café au lait", "pizza", "object category 50", "yellow lady's slipper",
]
TEMPLATE_SETS = {
    "rpo": ["a photo of a _."],  # cfg.DATASET.PROMPT of every dataset config
    "custom": sorted(set(CUSTOM_TEMPLATES.values())),
    "imagenet": IMAGENET_TEMPLATES,
}


@pytest.mark.parametrize("templates", list(TEMPLATE_SETS))
def test_tokenize_equals_jax_package(templates):
    texts = [
        t.replace("_", c) if "_" in t else t.format(c)
        for t in TEMPLATE_SETS[templates]
        for c in CLASSNAMES
    ]
    got = port.tokenize(texts)
    want = jax_tokenize(texts)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_constants_and_truncation():
    import rpo_tpu.tokenizer as jtok

    for name in ("CONTEXT_LENGTH", "EOT_TOKEN", "SOT_TOKEN", "VOCAB_SIZE"):
        assert getattr(port, name) == getattr(jtok, name)
    long = " ".join(["word"] * 100)
    with pytest.raises(RuntimeError):
        port.tokenize(long)
    np.testing.assert_array_equal(port.tokenize(long, truncate=True), jax_tokenize(long, truncate=True))
    tokens = port.tokenize(["a photo of a cat.", "a"])
    np.testing.assert_array_equal(port.eot_trim(tokens), jtok.eot_trim(tokens))
