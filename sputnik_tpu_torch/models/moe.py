"""MegaBlocks-style top-1 Mixture-of-Experts FFN (``sputnik_tpu/models/moe.py``).

Tokens are routed top-1. :func:`moe_forward` scatters them into per-expert
capacity slots (tokens past an expert's capacity are dropped) and runs the
expert FFN by ``impl``:

* ``"grouped"``: with fixed capacity the block-diagonal expert product is
  one batched GEMM per projection. Products whose fp32 result the JAX
  package keeps (``preferred_element_type=float32``) are taken on fp32
  copies of the operands, so a bf16 model routes as the JAX one does.
* ``"bsr"``: the block-sparse path on the block-diagonal topology, one
  fused SDD -> gelu -> DSD kernel (``kernels/bsr_ffn.py``) when
  ``plan_group_ffn`` finds the topology group-structured, else the unfused
  chain. Its backward recomputes through the unfused chain.
* ``"bsr_unfused"``: the chain ``ops.sdd`` -> gelu -> ``ops.dsd``.

:func:`dropless_moe_forward` drops nothing: every expert's tokens are
padded to a block multiple, and the block-diagonal topology of the step is
built on the device from the routed counts (MegaBlocks' dropless
construction), through ``ragged`` (a grouped GEMM), ``bsr`` (SDD/DSD on
:func:`dropless_topology`) or ``bsr_fused`` (one kernel that reads each
tile's expert on the device). No forward reads the device back to the
host, so each one can be captured in a CUDA graph.

Gradients flow as JAX's do: through the capacity scatter (dropped tokens
land on a sacrificial row that is sliced off), the permutation gathers, the
router's scale and the fused paths' recomputed chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sputnik_tpu_torch import ops
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_ffn
from sputnik_tpu_torch.utils import tracing
from sputnik_tpu_torch.utils.device import resolve_device

__all__ = [
    "MoEConfig", "MoE", "block_diag_topology", "init_moe_params", "moe_forward", "moe_loss",
    "dropless_topology", "dropless_moe_forward",
]


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
    """Parameters of one MoE FFN, all trainable: ``router`` (d, E) fp32,
    ``w1`` (d, E*F) and ``w2`` (E*F, d) in the model dtype, on ``device``
    (``None``: the card)."""

    def __init__(self, cfg: MoEConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, ef = cfg.d_model, cfg.ff_total
        p = lambda *shape, dtype: nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))  # noqa: E731
        self.router = p(d, cfg.n_experts, dtype=torch.float32)
        self.w1 = p(d, ef, dtype=cfg.dtype)
        self.w2 = p(ef, d, dtype=cfg.dtype)

    def forward(self, x, topology: Optional[BlockSparseMatrix] = None):
        return moe_forward(self, x, self.cfg, topology)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` with normal(0, std) draws from ``generator`` (drawn in fp32
    on the generator's device, then cast and copied)."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, device=None) -> MoE:
    """An :class:`MoE` on ``device`` with random weights from ``generator``,
    at the JAX package's scales (``device=None``: the card)."""
    m = MoE(cfg, device=device)
    normal_(m.router, 1.0 / math.sqrt(cfg.d_model), generator)
    normal_(m.w1, 1.0 / math.sqrt(cfg.d_model), generator)
    normal_(m.w2, 1.0 / math.sqrt(cfg.d_ff), generator)
    return m


def block_diag_topology(cfg: MoEConfig, device=None) -> BlockSparseMatrix:
    """Block-diagonal topology: expert e's capacity rows hit only its own
    d_ff columns. Built from numpy, so its fused-FFN plan is made and cached
    here, with its column ids on ``device`` (``None``: the card): a forward
    reads nothing back."""
    device = resolve_device(device)
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
    cols = cols.astype(np.int32)
    topo = BlockSparseMatrix.create(
        torch.zeros((len(rows), bs, bs), dtype=cfg.dtype, device=device),
        offsets, cols, (cfg.padded_tokens, cfg.ff_total),
    )
    bsr_ffn.remember_plan(topo, offsets, cols)
    return topo


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot rows, by comparison with ``arange`` (``F.one_hot``
    checks its input's range with a device read on CUDA)."""
    return (ids[:, None] == torch.arange(n, device=ids.device)).long()


def _route(logits: torch.Tensor, cfg: MoEConfig):
    """Top-1 routing with capacity slots. Returns (slot, keep, prob, aux)."""
    probs = torch.softmax(logits.float(), dim=-1)
    prob, expert = probs.max(dim=-1)
    onehot = _one_hot(expert, cfg.n_experts)
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


def _gelu_blocks(h: BlockSparseMatrix, cfg: MoEConfig) -> BlockSparseMatrix:
    return h.with_data(F.gelu(h.data.float(), approximate="tanh").to(cfg.dtype))


def _unfused_bsr_ffn(x_perm, w1, w2, cfg: MoEConfig, topology: BlockSparseMatrix) -> torch.Tensor:
    """SDD -> gelu -> DSD, differentiable through ``ops.autodiff``."""
    h = ops.sdd(x_perm, w1, topology)  # sparse (rows, E*F)
    return ops.dsd(_gelu_blocks(h, cfg), w2)  # (rows, d)


def _recompute_grads(ctx, g, x, w1, w2, chain):
    """Gradients of ``chain(x, w1, w2)`` at cotangent ``g`` for the inputs
    that need one: the fused paths' backward, recomputed through the
    unfused sparse chain (JAX's ``custom_vjp`` bwd)."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip((x, w1, w2), ctx.needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(chain(*inputs), wanted, g))
    return [next(grads) if t.requires_grad else None for t in inputs]


class _FusedBsrFfn(torch.autograd.Function):
    """``_fused_bsr_ffn`` (``sputnik_tpu/models/moe.py:131-156``): forward
    through the one-kernel group FFN, backward recomputed through the
    unfused chain on ``g`` in the storage dtype (every gradient sparse)."""

    @staticmethod
    def forward(ctx, x_perm, w1, w2, topology, plan, cfg):
        ctx.save_for_backward(x_perm, w1, w2)
        ctx.meta = (topology, cfg)
        return bsr_ffn.fused_group_ffn(x_perm, w1, w2, topology, activation="gelu",
                                       out_dtype=cfg.dtype, plan=plan)

    @staticmethod
    def backward(ctx, g):
        topology, cfg = ctx.meta
        grads = _recompute_grads(ctx, g.to(cfg.dtype).contiguous(), *ctx.saved_tensors,
                                 lambda x, a, b: _unfused_bsr_ffn(x, a, b, cfg, topology))
        return (*grads, None, None, None)


@tracing.traced("moe", inputs=(1,))
def moe_forward(
    params,
    x: torch.Tensor,  # (tokens, d_model)
    cfg: MoEConfig,
    topology: Optional[BlockSparseMatrix] = None,
    *,
    impl: str = "grouped",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss); y has x's shape and dtype. ``params`` is an
    :class:`MoE` (or anything with ``router``, ``w1``, ``w2``). ``impl`` is
    ``"grouped"`` (default; reads no topology), ``"bsr"`` (the fused kernel
    when ``plan_group_ffn(topology)`` accepts the topology, else the unfused
    chain) or ``"bsr_unfused"``; the bsr impls need ``topology``
    (:func:`block_diag_topology`)."""
    if impl not in ("grouped", "bsr", "bsr_unfused"):
        raise ValueError(f"impl must be 'grouped', 'bsr' or 'bsr_unfused', got {impl!r}")
    if impl != "grouped" and topology is None:
        raise ValueError(f"impl={impl!r} needs the block-diagonal topology")
    slot, keep, prob, aux = _route(router_logits(params, x, cfg), cfg)
    if tracing.recording():
        tracing.count("moe.tokens_routed", x.shape[0])
        tracing.count_device("moe.tokens_kept", keep)
        tracing.count("moe.slots_computed", cfg.padded_tokens)

    # Scatter tokens into expert capacity slots; dropped tokens all land on a
    # sacrificial extra row that is sliced off, so duplicate indices only
    # ever meet there.
    slot_or_drop = torch.where(keep, slot, cfg.padded_tokens)
    x_perm = torch.zeros((cfg.padded_tokens + 1, x.shape[1]), dtype=cfg.dtype, device=x.device)
    x_perm[slot_or_drop] = x.to(cfg.dtype)
    x_perm = x_perm[: cfg.padded_tokens]

    if impl == "grouped":
        e, c, d, f = cfg.n_experts, cfg.capacity, cfg.d_model, cfg.d_ff
        xg = x_perm.reshape(e, c, d).float()
        w1 = params.w1.reshape(d, e, f).permute(1, 0, 2).float()  # (e, d, f)
        w2 = params.w2.reshape(e, f, d).float()
        h = F.gelu(torch.bmm(xg, w1), approximate="tanh").to(cfg.dtype)
        y = torch.bmm(h.float(), w2).reshape(e * c, d)[slot]
        return (y * (prob * keep.float())[:, None]).to(x.dtype), aux

    plan = bsr_ffn.plan_group_ffn(topology) if impl == "bsr" else None
    if plan is not None:
        y_perm = _FusedBsrFfn.apply(x_perm, params.w1, params.w2, topology, plan, cfg)
    else:
        y_perm = _unfused_bsr_ffn(x_perm, params.w1, params.w2, cfg, topology)
    # y_perm is in the storage dtype: the scale is rounded to it, as in JAX.
    y = y_perm[slot] * (prob * keep.float()).to(y_perm.dtype)[:, None]
    return y.to(x.dtype), aux


def moe_loss(params, x: torch.Tensor, target: torch.Tensor, cfg: MoEConfig,
             topology: Optional[BlockSparseMatrix] = None) -> torch.Tensor:
    """fp32 mean squared error of the MoE output against ``target`` plus the
    weighted router aux loss (``sputnik_tpu/models/moe.py:239-242``)."""
    y, aux = moe_forward(params, x, cfg, topology)
    mse = torch.mean((y.float() - target.float()) ** 2)
    return mse + cfg.router_aux_weight * aux


@tracing.traced("moe", inputs=(1,))
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


# ---------------------------------------------------------------------------
# Dropless MoE: a block-diagonal topology built on the device every step
# ---------------------------------------------------------------------------


def dropless_topology(expert_rows: torch.Tensor, cfg: MoEConfig, max_block_rows: int) -> BlockSparseMatrix:
    """Block-diagonal topology whose group sizes live on the device
    (MegaBlocks' dropless construction): padded block-row r belongs to the
    expert whose cumulative block-row count first exceeds r (rows past the
    last group clamp to E-1) and hits that expert's d_ff column blocks.
    Offsets are static (every row has d_ff / bs blocks); only the column ids
    depend on ``expert_rows``, and nothing is read back to the host. The
    topology's values are never read (SDD writes fresh blocks), so ``data``
    is a zero view that allocates nothing."""
    bs = cfg.block_size
    f_blocks = cfg.d_ff // bs
    dev = expert_rows.device
    nnz = max_block_rows * f_blocks
    offsets = torch.arange(max_block_rows + 1, dtype=torch.int32, device=dev) * f_blocks
    row_of = torch.arange(max_block_rows, dtype=torch.int32, device=dev)[:, None].expand(-1, f_blocks)
    bounds = torch.cumsum(expert_rows, dim=0)
    expert_of_row = torch.searchsorted(
        bounds, torch.arange(max_block_rows, dtype=bounds.dtype, device=dev), right=True
    ).clamp(max=cfg.n_experts - 1)
    indices = expert_of_row[:, None] * f_blocks + torch.arange(f_blocks, device=dev)
    data = torch.zeros((), dtype=cfg.dtype, device=dev).expand(nnz, bs, bs)
    return BlockSparseMatrix.create(
        data, offsets, indices.reshape(-1), (max_block_rows * bs, cfg.ff_total),
        row_indices=row_of.reshape(-1), max_row_nnz=f_blocks,
    )


class _FusedDroplessFfn(torch.autograd.Function):
    """``_fused_dropless_diff`` (``sputnik_tpu/models/moe.py:286-324``):
    forward through the one-kernel dropless FFN, backward recomputed
    through the unfused chain on :func:`dropless_topology`. The integer
    inputs get no gradient."""

    @staticmethod
    def forward(ctx, x_perm, w1, w2, e_of_row, expert_rows, cfg, max_block_rows):
        ctx.save_for_backward(x_perm, w1, w2, expert_rows)
        ctx.meta = (cfg, max_block_rows)
        tile_rows = x_perm.shape[0] // e_of_row.shape[0]
        # Routed tiles this step, on the device: tiles past it skip all
        # compute; their rows are never gathered by `dest`.
        live = (expert_rows.sum() * cfg.block_size) // tile_rows
        return bsr_ffn.fused_dropless_ffn(
            x_perm, w1, w2, e_of_row, cfg.d_ff, bs=cfg.block_size, tile_rows=tile_rows,
            live_rows=live, activation="gelu", out_dtype=cfg.dtype,
        )

    @staticmethod
    def backward(ctx, g):
        x_perm, w1, w2, expert_rows = ctx.saved_tensors
        cfg, max_block_rows = ctx.meta
        topo = dropless_topology(expert_rows, cfg, max_block_rows)
        grads = _recompute_grads(ctx, g.to(cfg.dtype).contiguous(), x_perm, w1, w2,
                                 lambda x, a, b: _unfused_bsr_ffn(x, a, b, cfg, topo))
        return (*grads, None, None, None, None)


def _ragged_mm(a: torch.Tensor, b: torch.Tensor, group_sizes: torch.Tensor, bs: int) -> torch.Tensor:
    """``jax.lax.ragged_dot``: rows of ``a`` in consecutive groups of
    ``group_sizes`` (block multiples) times ``b[g]`` (E, K, N), in a's
    dtype with fp32 accumulation. bf16 on the card takes
    ``torch._grouped_mm`` with device offsets; otherwise a ``bmm`` per
    block-row against its group's gathered ``b``. Rows past the groups'
    total are left unspecified (JAX gives zeros; the caller never reads
    them). Neither reads the device back."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        offs = torch.cumsum(group_sizes, dim=0).to(torch.int32)
        return torch._grouped_mm(a, b, offs=offs)
    n_blocks = a.shape[0] // bs
    bounds = torch.cumsum(group_sizes // bs, dim=0)
    group = torch.searchsorted(bounds, torch.arange(n_blocks, dtype=bounds.dtype, device=a.device),
                               right=True).clamp(max=b.shape[0] - 1)
    out = torch.bmm(a.view(n_blocks, bs, -1).float(), b[group].float())
    return out.reshape(a.shape[0], b.shape[2]).to(a.dtype)


def _dropless_route(logits: torch.Tensor, t: int, cfg: MoEConfig, row_group: int):
    """The dropless routing glue of ``sputnik_tpu/models/moe.py:354-391``:
    (max_block_rows, probs, prob, expert, onehot, expert_rows, dest, src).
    Every tensor stays on the device."""
    bs, e = cfg.block_size, cfg.n_experts
    max_block_rows = (-(-t // bs) // row_group + e) * row_group  # static
    t_pad = max_block_rows * bs
    probs = torch.softmax(logits, dim=-1)
    prob, expert = probs.max(dim=-1)
    onehot = _one_hot(expert, e)
    counts = onehot.sum(dim=0)
    expert_rows = -(-counts // bs)  # padded block rows per expert
    if row_group > 1:
        expert_rows = -(-expert_rows // row_group) * row_group
    group_start = (torch.cumsum(expert_rows, dim=0) - expert_rows) * bs
    pos_in_expert = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    dest = group_start[expert] + pos_in_expert  # always < t_pad (no drops)
    # Padding slots clamp to the last token instead of a zero row: their
    # outputs are never gathered back (dest maps real tokens only) and their
    # cotangents are exactly zero, so no value or gradient leaks.
    src = torch.full((t_pad,), t - 1, dtype=torch.int64, device=logits.device)
    src = src.scatter(0, dest, torch.arange(t, device=logits.device))
    return max_block_rows, probs, prob, expert, onehot, expert_rows, dest, src


@tracing.traced("moe", inputs=(1,))
def dropless_moe_forward(
    params,
    x: torch.Tensor,  # (tokens, d_model)
    cfg: MoEConfig,
    *,
    impl: str = "ragged",
    row_group: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless top-1 MoE FFN: no capacity, no dropped token. Every expert's
    token group is padded up to ``row_group`` blocks; the padded rows are
    statically bounded by tokens + n_experts * row_group blocks, and the
    block-diagonal topology of the step is computed on the device. Returns
    (y, aux_loss); y has x's shape and dtype. ``impl``: ``"ragged"``,
    ``"bsr"`` or ``"bsr_fused"``; ``row_group`` defaults to 2 for
    ``"bsr_fused"`` (its kernel tile is row_group blocks), else 1."""
    if impl not in ("ragged", "bsr", "bsr_fused"):
        raise ValueError(f"impl must be 'ragged', 'bsr' or 'bsr_fused', got {impl!r}")
    t = x.shape[0]
    bs, e = cfg.block_size, cfg.n_experts
    if row_group is None:
        row_group = 2 if impl == "bsr_fused" else 1
    max_block_rows, probs, prob, expert, onehot, expert_rows, dest, src = _dropless_route(
        router_logits(params, x, cfg), t, cfg, row_group)
    x_perm = x.to(cfg.dtype)[src]

    if impl == "ragged":
        group_sizes = expert_rows * bs
        w1 = params.w1.reshape(cfg.d_model, e, cfg.d_ff).permute(1, 0, 2)  # (e, d, F)
        w2 = params.w2.reshape(e, cfg.d_ff, cfg.d_model)
        h = _ragged_mm(x_perm, w1, group_sizes, bs)
        h = F.gelu(h.float(), approximate="tanh").to(cfg.dtype)
        y_perm = _ragged_mm(h, w2, group_sizes, bs)
    elif impl == "bsr":
        topo = dropless_topology(expert_rows, cfg, max_block_rows)
        y_perm = _unfused_bsr_ffn(x_perm, params.w1, params.w2, cfg, topo)
    else:
        # One kernel; the expert id per kernel tile (row_group block rows;
        # groups are padded to row_group multiples, so a tile never
        # straddles two experts) is computed and read on the device.
        bounds = torch.cumsum(expert_rows, dim=0)
        tile_first_row = torch.arange(max_block_rows // row_group, device=x.device) * row_group
        e_of_row = torch.searchsorted(bounds, tile_first_row, right=True).clamp(max=e - 1)
        y_perm = _FusedDroplessFfn.apply(x_perm, params.w1, params.w2, e_of_row.to(torch.int32),
                                         expert_rows, cfg, max_block_rows)

    # Scale in the storage dtype, as JAX does.
    y = y_perm[dest] * prob.to(y_perm.dtype)[:, None]
    aux = e * torch.sum(probs.mean(dim=0) * onehot.float().mean(dim=0))
    return y.to(x.dtype), aux
