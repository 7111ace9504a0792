"""step_mfu.train's reading for the multihost cell,
which reports its own end-to-end metric, train_pairs_per_s.multihost."""
from benchmark.metrics._read import mfu


def read(st):
    return mfu(st, "train")
