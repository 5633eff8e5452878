"""Kernels of the port: hand-written CUDA for Hopper, their wrappers and plain versions."""

from sputnik_tpu_torch.kernels import bsr_dsd, bsr_dss, bsr_sdd, bsr_ssd, reference

__all__ = ["bsr_dsd", "bsr_sdd", "bsr_ssd", "bsr_dss", "reference"]
