"""``mfu.train``: the step's operations times the window's steps, over the window's seconds times the card's peak, in percent."""
from benchmark import readers


def read(r):
    return readers.mfu(r, "train")
