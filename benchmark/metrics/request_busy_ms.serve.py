"""Device busy ms a request: the union of the device's operations over the
profiled stretch, by the requests in it."""
from benchmark.metrics._read import busy_ms


def read(st):
    return busy_ms(st, "serve")
