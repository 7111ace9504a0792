"""Mean ms of each next() of the stream handed to the step, over the
traced run's unprofiled stretch (the benchmark's own span)."""
from benchmark.metrics._read import span_ms


def read(st):
    return span_ms(st, "train", "next")
