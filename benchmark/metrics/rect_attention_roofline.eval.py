"""``rect_attention_roofline.eval``: the rect_attention kernel's calls in the traced eval steps, their
summed bound over their summed device time, in percent."""
from benchmark import readers


def read(r):
    return readers.roofline(r, "eval", "rect_attention kernel")
