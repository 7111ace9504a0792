"""step_busy_ms.train's reading for the multihost cell,
which reports its own end-to-end metric, train_pairs_per_s.multihost."""
from benchmark.metrics._read import busy_ms


def read(st):
    return busy_ms(st, "train")
