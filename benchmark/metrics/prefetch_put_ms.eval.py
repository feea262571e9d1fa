"""``prefetch_put_ms.eval``: the host's milliseconds a traced batch taking
the prefetch's next batch (pinning a batch and queueing its copy): the
benchmark's ``prefetch put`` spans, one a batch and one more that finds
the end."""
from benchmark import host_split


def read(r):
    return host_split.eval_ms(r, "prefetch put", extra=1)
