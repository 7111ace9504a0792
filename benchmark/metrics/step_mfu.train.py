"""% of the chip's peak matmul rate that the model's FLOPs a step reach
over the traced run's unprofiled stretch."""
from benchmark.metrics._read import mfu


def read(st):
    return mfu(st, "train")
