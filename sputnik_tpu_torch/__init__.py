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
MoE benchmark, and the sparse LM's serving path and training loss; the
CSR engine (``CsrMatrix``, ``EllMatrix``, ``SellMatrix``, ``ops.csr``: SpMM,
its transpose, SDDMM and sparse softmax with gradients) on four more
(``csrc/sell.cu``), the DLMC pruning utilities and the DLMC benchmark;
the sparse-output and sparse x sparse products SSD / SDS / DSS / SSS with
their gradients on four more (``csrc/bsr_flat.cu``, ``csrc/bsr_ssd.cu``,
``csrc/bsr_dss.cu``: exact host-planned work lists, and output-stationary,
position-map and device-built work-list kernels for metadata built on the
card) and the DSS benchmark; the rest of block-sparse attention on three
more (``csrc/bsr_softmax.cu``: the BSR softmax's stats and normalize
passes, which need no max_row_nnz hint, and the fused SDD + softmax's
score pass) and on the flash kernels at one head
(``flash_block_attention``): content-routed top-k attention, top-k and
sampled serving, and the serving benchmark; block sizes 16, 32 and 64 on
two more (``csrc/bsr_small.cu``: packed DSD / DDS and SDD) with block
pruning and RigL (``prune``); int8 quantized serving (``ops.quant``) on the
stream kernel's int8 mode and one more (``csrc/bsr_bres.cu``, q blocks per
step); the benchmark tools (``bench``: the headline with its tune pass,
calibration, the MXU probes on three more, the roofline audit) and the
autotune cache (``ops.autotune``, versioned by ``__version__``); the other
DSD / DDS / SDD schedules on seven more (``csrc/bsr_dsd_pipelined.cu``,
``csrc/bsr_qstream.cu``, ``csrc/bsr_cres.cu``: contraction-major with the
accumulator kept to one flush, whole-output or per group,
``csrc/bsr_sdd_bres.cu``, ``csrc/bsr_panel.cu`` and ``csrc/bsr_cstack.cu``)
and the variant tools (``bench.tune``, ``headline``, ``grid``,
``grid_summary``, ``sss_floor``, ``flash_sweep``); the distributed layer
(``parallel``: the row-, K-band- and column-partitioned BSR / CSR / SELL
matmuls, sequence-parallel and ring block-sparse attention over a
``torch.distributed`` process group) with ring attention's band fold on
the last one (``csrc/flash_fold.cu``).
Entry points build on the CUDA card unless given ``device="cpu"``. It
imports torch and never jax.
"""

__version__ = "0.10.0"

from sputnik_tpu_torch import models, ops, prune  # noqa: E402
from sputnik_tpu_torch.formats import (  # noqa: E402
    BlockSparseMatrix,
    CsrMatrix,
    EllMatrix,
    SellMatrix,
    bsr_from_dense,
    bsr_to_dense,
    csr_from_dense,
    csr_to_dense,
    sorted_row_swizzle,
)
from sputnik_tpu_torch.ops import (  # noqa: E402
    matmul, matmul_dds, matmul_dsd, matmul_dss, matmul_sdd, matmul_sds, matmul_ssd, matmul_sss,
)

__all__ = [
    "BlockSparseMatrix", "bsr_from_dense", "bsr_to_dense", "models", "ops", "prune", "matmul",
    "matmul_dsd", "matmul_dds", "matmul_sdd", "matmul_ssd", "matmul_sds", "matmul_dss", "matmul_sss",
    "CsrMatrix", "EllMatrix", "SellMatrix", "csr_from_dense", "csr_to_dense", "sorted_row_swizzle",
]
