"""sputnik_tpu_torch: the PyTorch / CUDA port of sputnik_tpu for NVIDIA Hopper.

The JAX package ``sputnik_tpu`` is the reference; this package mirrors its
module paths. Ported so far: the BSR format and metadata, the first-fit
kernel registry, DSD / DDS / SDD and their gradients on two hand-written
CUDA kernels (``csrc/bsr_dsd.cu``, ``csrc/bsr_sdd.cu``), fused flash
attention with its backward on three more (``csrc/flash_mha.cu``), the
fused MoE FFN on two more (``csrc/bsr_ffn.cu``: group-structured and
dropless), all built with nvcc for sm_90a on first use; the BSR softmax,
block-sparse attention, the MoE FFN (grouped, block-sparse fused and
unfused, and dropless on a topology built on the device every step), the
MoE benchmark, and the sparse LM's serving path and training loss. It
imports torch and never jax.
"""

from sputnik_tpu_torch import models, ops
from sputnik_tpu_torch.formats import BlockSparseMatrix, bsr_from_dense, bsr_to_dense
from sputnik_tpu_torch.ops import matmul_dds, matmul_dsd, matmul_sdd

__all__ = [
    "BlockSparseMatrix", "bsr_from_dense", "bsr_to_dense", "models", "ops",
    "matmul_dsd", "matmul_dds", "matmul_sdd",
]
