"""``dispatch_self_ms.train``: the host's milliseconds a measured step in
the train dispatch outside its staging and launch (the LR fill, the state
check, the clones, the summaries): the self time of the program's
``train_dispatch`` spans (``CLIPMethodTrainer._dispatch``), read from the
measured window with no profiler."""
from benchmark import host_split


def read(r):
    return host_split.train_ms(r, "train_dispatch", self_time=True)
