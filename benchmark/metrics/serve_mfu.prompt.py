"""serve_mfu.prompt: Percent of the bf16 peak: the traced window's useful operations (flops.py) over the window."""

from benchmark import readers


def read(r):
    return readers.mfu(r)
