"""Where the port builds what it is asked to build.

Every constructor of the port (parameters, topologies, caches, sparse
matrices made from numpy) takes ``device=None`` and builds on the card then.
The CPU is used only when the caller asks for it: on a machine without a
card, ``device=None`` raises rather than falling back quietly. Functions
that take an existing tensor keep that tensor's device instead.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the card unless asked otherwise; "
            'pass device="cpu" to build on the CPU'
        )
    return torch.device("cuda")
