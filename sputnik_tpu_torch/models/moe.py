"""Top-1 Mixture-of-Experts FFN (``sputnik_tpu/models/moe.py``, ``impl="grouped"``).

Tokens are routed top-1 and scattered into per-expert capacity slots; with
fixed capacity the block-diagonal expert product is one batched GEMM per
projection. Products whose fp32 result the JAX package keeps
(``preferred_element_type=float32``: the router logits that decide routing,
and the expert GEMMs feeding gelu and the output scale) are taken on fp32
copies of the operands, so a bf16 model routes as the JAX one does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sputnik_tpu_torch.formats import BlockSparseMatrix

__all__ = ["MoEConfig", "MoE", "block_diag_topology", "init_moe_params", "moe_forward"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 512
    d_ff: int = 1024  # hidden units per expert
    n_experts: int = 8
    capacity: int = 256  # token slots per expert (multiple of block_size)
    block_size: int = 128
    dtype: torch.dtype = torch.bfloat16
    router_aux_weight: float = 0.01

    def __post_init__(self):
        if self.capacity % self.block_size or self.d_ff % self.block_size:
            raise ValueError("capacity and d_ff must be multiples of block_size")

    @property
    def padded_tokens(self) -> int:
        return self.n_experts * self.capacity

    @property
    def ff_total(self) -> int:
        return self.n_experts * self.d_ff


class MoE(nn.Module):
    """Parameters of one MoE FFN: ``router`` (d, E) fp32, ``w1`` (d, E*F) and
    ``w2`` (E*F, d) in the model dtype. Frozen: the port serves, it does not
    train yet."""

    def __init__(self, cfg: MoEConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, ef = cfg.d_model, cfg.ff_total
        p = lambda *shape, dtype: nn.Parameter(  # noqa: E731
            torch.zeros(shape, dtype=dtype, device=device), requires_grad=False
        )
        self.router = p(d, cfg.n_experts, dtype=torch.float32)
        self.w1 = p(d, ef, dtype=cfg.dtype)
        self.w2 = p(ef, d, dtype=cfg.dtype)

    def forward(self, x, topology: Optional[BlockSparseMatrix] = None):
        return moe_forward(self, x, self.cfg, topology)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` with normal(0, std) draws from ``generator`` (drawn in fp32
    on the generator's device, then cast and copied)."""
    t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, device=None) -> MoE:
    """An :class:`MoE` on ``device`` with random weights from ``generator``,
    at the JAX package's scales."""
    m = MoE(cfg, device=device)
    normal_(m.router, 1.0 / math.sqrt(cfg.d_model), generator)
    normal_(m.w1, 1.0 / math.sqrt(cfg.d_model), generator)
    normal_(m.w2, 1.0 / math.sqrt(cfg.d_ff), generator)
    return m


def block_diag_topology(cfg: MoEConfig, device=None) -> BlockSparseMatrix:
    """Block-diagonal topology: expert e's capacity rows hit only its own
    d_ff columns. The grouped path does not read it; it is kept so the
    model's topologies match the JAX package's."""
    bs = cfg.block_size
    rows_per, cols_per = cfg.capacity // bs, cfg.d_ff // bs
    e = np.arange(cfg.n_experts)[:, None, None]
    r = np.arange(rows_per)[None, :, None]
    c = np.arange(cols_per)[None, None, :]
    rows = np.broadcast_to(e * rows_per + r, (cfg.n_experts, rows_per, cols_per)).ravel()
    cols = np.broadcast_to(e * cols_per + c, (cfg.n_experts, rows_per, cols_per)).ravel()
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=cfg.padded_tokens // bs))]
    ).astype(np.int32)
    return BlockSparseMatrix.create(
        torch.zeros((len(rows), bs, bs), dtype=cfg.dtype, device=device),
        offsets, cols.astype(np.int32), (cfg.padded_tokens, cfg.ff_total),
    )


def _route(logits: torch.Tensor, cfg: MoEConfig):
    """Top-1 routing with capacity slots. Returns (slot, keep, prob, aux)."""
    probs = torch.softmax(logits.float(), dim=-1)
    prob, expert = probs.max(dim=-1)
    onehot = F.one_hot(expert, cfg.n_experts)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = pos < cfg.capacity
    slot = expert * cfg.capacity + pos.clamp(max=cfg.capacity - 1)
    # Switch-style load-balancing auxiliary loss.
    aux = cfg.n_experts * torch.sum(probs.mean(dim=0) * onehot.float().mean(dim=0))
    return slot, keep, prob, aux


def router_logits(params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """fp32 logits of the storage-dtype operands (JAX: one bf16 MXU pass with
    fp32 accumulation)."""
    return x.to(cfg.dtype).float() @ params.router.to(cfg.dtype).float()


def moe_forward(
    params,
    x: torch.Tensor,  # (tokens, d_model)
    cfg: MoEConfig,
    topology: Optional[BlockSparseMatrix] = None,
    *,
    impl: str = "grouped",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss); y has x's shape and dtype. ``params`` is an
    :class:`MoE` (or anything with ``router``, ``w1``, ``w2``). ``topology``
    keeps the JAX signature; the grouped path does not read it."""
    if impl != "grouped":
        raise ValueError(f"impl {impl!r} is not ported; only 'grouped' is")
    slot, keep, prob, aux = _route(router_logits(params, x, cfg), cfg)

    # Scatter tokens into expert capacity slots; dropped tokens all land on a
    # sacrificial extra row that is sliced off, so duplicate indices only
    # ever meet there.
    slot_or_drop = torch.where(keep, slot, cfg.padded_tokens)
    x_perm = torch.zeros((cfg.padded_tokens + 1, x.shape[1]), dtype=cfg.dtype, device=x.device)
    x_perm[slot_or_drop] = x.to(cfg.dtype)
    x_perm = x_perm[: cfg.padded_tokens]

    e, c, d, f = cfg.n_experts, cfg.capacity, cfg.d_model, cfg.d_ff
    xg = x_perm.reshape(e, c, d).float()
    w1 = params.w1.reshape(d, e, f).permute(1, 0, 2).float()  # (e, d, f)
    w2 = params.w2.reshape(e, f, d).float()
    h = F.gelu(torch.bmm(xg, w1), approximate="tanh").to(cfg.dtype)
    y_perm = torch.bmm(h.float(), w2).reshape(e * c, d)

    y = y_perm[slot] * (prob * keep.float())[:, None]
    return y.to(x.dtype), aux


def moe_one(params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Per-token top-1 MoE FFN, y = prob * expert(x), for decoding: the
    per-token semantics of :func:`moe_forward` when no token is dropped.
    x is (..., d); every token takes its own expert's weights."""
    lead = x.shape[:-1]
    xt = x.reshape(-1, cfg.d_model).to(cfg.dtype)
    probs = torch.softmax(router_logits(params, xt, cfg), dim=-1)
    prob, e = probs.max(dim=-1)
    d, f = cfg.d_model, cfg.d_ff
    w1_e = params.w1.reshape(d, cfg.n_experts, f)[:, e, :].permute(1, 0, 2)  # (n, d, f)
    w2_e = params.w2.reshape(cfg.n_experts, f, d)[e]  # (n, f, d)
    h = F.gelu(torch.bmm(xt.float()[:, None, :], w1_e.float()), approximate="tanh").to(cfg.dtype)
    y = torch.bmm(h.float(), w2_e.float())[:, 0, :]
    return (y * prob[:, None]).to(cfg.dtype).reshape(lead + (d,))
