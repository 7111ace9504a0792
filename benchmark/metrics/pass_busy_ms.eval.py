"""Device busy ms a pass: the union of the device's operations over the
profiled stretch, by the passs in it."""
from benchmark.metrics._read import busy_ms


def read(st):
    return busy_ms(st, "eval")
