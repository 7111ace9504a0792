"""% of the profiled window of passs with no device operation running."""
from benchmark.metrics._read import idle


def read(st):
    return idle(st, "eval")
