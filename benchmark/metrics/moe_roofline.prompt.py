"""moe_roofline.prompt: Percent: the layer's least time (flops.py, bytes once) over the device time under its ranges."""

from benchmark import readers

RANGES = list(readers.MOE)


def read(r):
    return readers.roofline(r, RANGES)
