"""decode_step_ms.gen: Milliseconds: median CUDA-event time of the wrapped calls."""

from benchmark import readers

RANGES = [readers.DECODE]


def read(r):
    return readers.median_ms(r, readers.DECODE)
