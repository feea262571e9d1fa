"""``step_device_ms.train``: device milliseconds a step: the summed time of the traced steps' device operations over the steps."""
from benchmark import readers


def read(r):
    return readers.device_ms(r, "train")
