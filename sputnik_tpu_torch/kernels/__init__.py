"""Kernels of the port: hand-written CUDA for Hopper, their wrappers and plain versions."""
