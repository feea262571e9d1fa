"""``batch_device_ms.eval``: device milliseconds a batch: the summed time of the traced batches' device operations over the batches."""
from benchmark import readers


def read(r):
    return readers.device_ms(r, "eval")
