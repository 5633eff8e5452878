"""device_idle_pct.prompt: Percent of the traced window in which no work runs on the device."""

from benchmark import readers


def read(r):
    return readers.idle_pct(r)
