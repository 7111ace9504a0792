"""loader_next_ms.train's reading for the multihost cell,
which reports its own end-to-end metric, train_pairs_per_s.multihost."""
from benchmark.metrics._read import span_ms


def read(st):
    return span_ms(st, "train", "next")
