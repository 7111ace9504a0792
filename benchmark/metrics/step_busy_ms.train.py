"""Device busy ms a step: the union of the device's operations over the
profiled stretch, by the steps in it."""
from benchmark.metrics._read import busy_ms


def read(st):
    return busy_ms(st, "train")
