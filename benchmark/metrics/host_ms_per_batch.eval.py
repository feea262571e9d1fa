"""``host_ms_per_batch.eval``: the host's milliseconds inside each prefetch put and model_inference_async, over the window's batches."""
from benchmark import readers


def read(r):
    return readers.host_ms(r, "eval")
