"""Benchmarks of the port on a CUDA card (``sputnik_tpu/bench``)."""
