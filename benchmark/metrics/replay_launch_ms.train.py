"""``replay_launch_ms.train``: the host's milliseconds a measured step in
``graph.replay()``: the program's ``replay`` spans (``StepGraph.run``),
read from the measured window with no profiler."""
from benchmark import host_split


def read(r):
    return host_split.train_ms(r, "replay")
