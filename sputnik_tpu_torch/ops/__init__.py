"""Public op layer: the BSR matmuls, their registry and gradients, the BSR
softmax and fused flash attention.

``dsd``, ``dds`` and ``sdd`` are the differentiable entry points the models
call (``ops/autodiff.py``); ``matmul_*`` are the raw dispatching front ends.
Both take the same options, ``variant=`` included. ``flash_mha`` is
registered with the variants ``cuda_flash`` and ``torch_reference``.
"""

from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.ops.autodiff import dds, dsd, sdd
from sputnik_tpu_torch.ops.matmul import matmul_dds, matmul_dsd, matmul_sdd
from sputnik_tpu_torch.ops.softmax import bsr_softmax

# Imported after ``registry``: the kernel module registers itself in it.
from sputnik_tpu_torch.kernels.flash_mha import flash_mha  # noqa: E402  isort: skip

__all__ = [
    "matmul_dsd", "matmul_dds", "matmul_sdd", "dsd", "dds", "sdd", "registry", "bsr_softmax",
    "flash_mha",
]
