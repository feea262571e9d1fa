"""``idle_share.eval``: percent of the traced window in which no operation ran on the device."""
from benchmark import readers


def read(r):
    return readers.idle_share(r, "eval")
