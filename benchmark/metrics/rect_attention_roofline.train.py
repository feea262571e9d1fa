"""``rect_attention_roofline.train``: the rect_attention kernel's calls in the traced train steps, their
summed bound over their summed device time, in percent."""
from benchmark import readers


def read(r):
    return readers.roofline(r, "train", "rect_attention kernel")
