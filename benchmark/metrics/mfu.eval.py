"""``mfu.eval``: the batch's operations times the window's batches, over the window's seconds times the card's peak, in percent."""
from benchmark import readers


def read(r):
    return readers.mfu(r, "eval")
