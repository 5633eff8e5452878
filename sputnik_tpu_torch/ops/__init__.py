"""Public op layer: the BSR matmuls, their registry and gradients, the BSR
softmax and fused flash attention, and the CSR engine (``ops.csr``: SpMM,
SDDMM and sparse softmax over CSR / ELL / SELL, with gradients).

``dsd``, ``dds``, ``sdd``, ``ssd``, ``sds``, ``dss`` and ``sss`` are the
differentiable entry points (``ops/autodiff.py``); ``matmul_*`` are the raw
dispatching front ends and ``matmul`` picks one by operand type. Both take
the same options, ``variant=`` included. ``plan_*`` build the exact work
lists (``FlatSchedule``) of the sparse-output ops on the host. ``flash_mha`` is
registered with the variants ``cuda_flash`` and ``torch_reference``;
``bsr_softmax`` takes ``variant="pallas"`` (its two kernels) or ``"jnp"``
(the torch chain); ``sdd_softmax`` is the fused SDD + softmax. ``quant``
is the int8 serving path (``quantize``, ``quantize_bsr``,
``matmul_dsd_q8``, ``matmul_dds_q8``).
"""

from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.ops.autodiff import dds, dsd, dss, sdd, sds, ssd, sss
from sputnik_tpu_torch.ops.matmul import (
    FlatSchedule, matmul, matmul_dds, matmul_dsd, matmul_dss, matmul_sdd, matmul_sds, matmul_ssd, matmul_sss,
    plan_dss, plan_sds, plan_ssd, plan_sss,
)
from sputnik_tpu_torch.ops.softmax import bsr_softmax, sdd_softmax

# Imported after ``registry``: the kernel modules register themselves in it.
from sputnik_tpu_torch.kernels.flash_mha import flash_mha  # noqa: E402  isort: skip
from sputnik_tpu_torch.ops import csr  # noqa: E402  isort: skip
from sputnik_tpu_torch.ops import quant  # noqa: E402  isort: skip

__all__ = [
    "matmul", "matmul_dsd", "matmul_dds", "matmul_sdd", "matmul_ssd", "matmul_sds", "matmul_dss", "matmul_sss",
    "dsd", "dds", "sdd", "ssd", "sds", "dss", "sss", "FlatSchedule", "plan_ssd", "plan_sds", "plan_dss",
    "plan_sss", "registry", "bsr_softmax", "sdd_softmax", "flash_mha", "csr", "quant",
]
