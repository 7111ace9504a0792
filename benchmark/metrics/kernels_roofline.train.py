"""% of the device's busy time over the profiled steps that their work
takes at its bound (FLOPs at the peak rate or bytes at the bandwidth)."""
from benchmark.metrics._read import roofline


def read(st):
    return roofline(st, "train")
