"""``eval_enqueue_ms.eval``: the host's milliseconds a traced batch queueing
the eval towers: the benchmark's ``launch`` spans around the trainer's
``model_inference_async``."""
from benchmark import host_split


def read(r):
    return host_split.eval_ms(r, "launch")
