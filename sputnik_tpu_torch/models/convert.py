"""Carry the JAX package's parameter tree over to the port's modules, and
the port's gradients back in the JAX tree's keys.

``params_from_numpy`` takes the tree as numpy (``jax.tree.map(np.asarray,
params)``): nested dicts and lists with the JAX keys, which name the
port's parameters one to one (``blocks[i]["moe"]["w1"]`` is
``blocks.<i>.moe.w1``). Layouts are the same, so nothing is transposed. ``grads_to_numpy`` is the
inverse direction for gradients: keyed like ``flatten_tree`` of the JAX
gradient tree. ``quantized_bsr_from_numpy`` carries int8 weights across:
the JAX package's ``quantize_bsr`` result, as numpy, becomes the port's
BSR and scale, so both packages serve the same int8 blocks. This module
never imports jax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.models.transformer import SparseLM, TransformerConfig
from sputnik_tpu_torch.utils.device import resolve_device

__all__ = ["flatten_tree", "load_numpy_", "params_from_numpy", "grads_to_numpy", "quantized_bsr_from_numpy"]


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"blocks": [{"moe": {"w1": x}}]} -> {"blocks.0.moe.w1": x}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(flatten_tree(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def load_numpy_(module: nn.Module, tree) -> nn.Module:
    """Copy a numpy tree into ``module``'s parameters, each cast to the
    parameter's dtype and device. Keys and shapes must match exactly."""
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(params) - set(flat))}, "
            f"unexpected {sorted(set(flat) - set(params))}"
        )
    with torch.no_grad():
        for name, p in params.items():
            # Through float32: numpy has no bfloat16 that torch can read, and
            # bf16 -> fp32 -> bf16 is exact.
            value = torch.from_numpy(np.array(flat[name], np.float32))
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(p.shape)}")
            p.copy_(value.to(device=p.device, dtype=p.dtype))
    return module


def params_from_numpy(tree, cfg: TransformerConfig, *, device=None) -> SparseLM:
    """A :class:`SparseLM` on ``device`` (``None``: the card) holding the JAX
    parameters ``tree``."""
    return load_numpy_(SparseLM(cfg, device=device), tree)


def grads_to_numpy(module: nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter's ``.grad`` as fp32 numpy, keyed like ``flatten_tree``
    of the JAX gradient tree (``blocks.<i>.moe.w1``); a parameter that got
    no gradient gives zeros, as ``jax.grad`` does."""
    return {
        name: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().cpu().numpy()
        for name, p in module.named_parameters()
    }


def quantized_bsr_from_numpy(data, offsets, indices, shape, scale, *, device=None):
    """The JAX package's quantized BSR as numpy (``(nnz, bs, bs)`` int8
    blocks, ``offsets``, ``indices``, the matrix shape) and its scale (a
    float per tensor, or the ``(block_rows,)`` per-block-row array) as the
    port's ``(BlockSparseMatrix, scale)`` on ``device`` (``None``: the
    card): int8 blocks, host-known metadata, and a float or an fp32
    tensor."""
    dev = resolve_device(device)
    blocks = np.asarray(data)
    if blocks.dtype != np.int8:
        raise ValueError(f"quantized blocks must be int8, got {blocks.dtype}")
    m = BlockSparseMatrix.create(torch.from_numpy(blocks).to(dev), offsets, indices, tuple(shape))
    if np.ndim(scale) == 0:
        return m, float(scale)
    return m, torch.from_numpy(np.asarray(scale, np.float32)).to(dev)
