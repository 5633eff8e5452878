"""prefill_ms.prompt: Milliseconds: median CUDA-event time of the wrapped calls."""

from benchmark import readers

RANGES = [readers.PREFILL]


def read(r):
    return readers.median_ms(r, readers.PREFILL)
