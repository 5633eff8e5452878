"""Benchmarks of the port on a CUDA card (``sputnik_tpu/bench``)."""

from sputnik_tpu_torch.bench import roofline

__all__ = ["roofline"]
