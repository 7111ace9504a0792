"""% of the window's wall time with no device operation running: the
profiled stretch's device busy time a step, times the steps of the
unprofiled stretch, against that stretch's seconds (the profiled
stretch's own idle share reads the profiler's host overhead in this
host-paced loop)."""
from benchmark.metrics._read import window_idle


def read(st):
    return window_idle(st, "train")
