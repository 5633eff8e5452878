"""Test utilities shared with the JAX package's conventions (``testing``),
device placement, profiling and the DLMC helpers."""

import importlib

__all__ = ["testing"]


def __getattr__(name):
    # Lazy: ``formats`` imports ``utils.device``, which runs this file, and
    # ``testing`` imports ``formats``; an eager import would close the cycle.
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
