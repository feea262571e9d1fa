"""``fused_text_layer_roofline.eval``: the fused_text_layer kernel's calls in the traced eval steps, their
summed bound over their summed device time, in percent."""
from benchmark import readers


def read(r):
    return readers.roofline(r, "eval", "fused_text_layer kernel")
