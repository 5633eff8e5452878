"""Public op layer: the BSR matmuls, their registry and the BSR softmax.

``dsd``, ``dds`` and ``sdd`` are the forward entry points the models call;
they take the same options as the ``matmul_*`` front ends, ``variant=``
included.
"""

from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.ops.matmul import matmul_dds, matmul_dsd, matmul_sdd
from sputnik_tpu_torch.ops.softmax import bsr_softmax

# The forward entry points the models call (JAX: ``sputnik_tpu.ops.dsd`` etc.,
# there wrapped in custom VJPs). Gradients are not ported yet, so they are
# the front ends themselves.
dsd, dds, sdd = matmul_dsd, matmul_dds, matmul_sdd

__all__ = ["matmul_dsd", "matmul_dds", "matmul_sdd", "dsd", "dds", "sdd", "registry", "bsr_softmax"]
