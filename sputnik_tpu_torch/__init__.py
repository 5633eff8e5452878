"""sputnik_tpu_torch: the PyTorch / CUDA port of sputnik_tpu for NVIDIA Hopper.

The JAX package ``sputnik_tpu`` is the reference; this package mirrors its
module paths. Ported so far: the BSR format and metadata, the first-fit
kernel registry, DSD / DDS / SDD on two hand-written CUDA kernels
(``csrc/bsr_dsd.cu``, ``csrc/bsr_sdd.cu``, built with nvcc for sm_90a on
first use), the BSR softmax, block-sparse attention, the grouped MoE FFN and
the sparse LM's serving path. It imports torch and never jax.
"""

from sputnik_tpu_torch import models, ops
from sputnik_tpu_torch.formats import BlockSparseMatrix, bsr_from_dense, bsr_to_dense
from sputnik_tpu_torch.ops import matmul_dds, matmul_dsd, matmul_sdd

__all__ = [
    "BlockSparseMatrix", "bsr_from_dense", "bsr_to_dense", "models", "ops",
    "matmul_dsd", "matmul_dds", "matmul_sdd",
]
