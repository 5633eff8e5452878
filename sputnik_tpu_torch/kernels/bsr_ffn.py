"""Fused block-sparse FFN, SDD -> activation -> DSD in one kernel: the
MegaBlocks MoE forward with the hidden activations kept out of device
memory, on the ``bsr_ffn`` CUDA kernels (``csrc/bsr_ffn.cu``).

Port of ``sputnik_tpu/kernels/bsr_ffn.py``:

* :func:`plan_group_ffn` finds the group structure of a topology on the
  host (equal-size runs of block-rows that share one column run), as JAX
  does, and returns ``None`` when there is none.
* :func:`fused_group_ffn` computes ``act(SDD(x, w1, topology)) @ w2`` for a
  group-structured topology, reading each group's column ids from the
  plan (``bsr_ffn_group``).
* :func:`fused_dropless_ffn` is the dropless MoE's FFN: the expert of each
  tile of ``tile_rows`` rows is a device tensor rebuilt every step, and
  tiles at or past ``live_rows`` compute nothing and leave their output
  rows unwritten (``torch.empty``); callers never read them
  (``bsr_ffn_dropless``).

Both dispatch through the registry (ops ``fused_group_ffn`` and
``fused_dropless_ffn``, variants ``cuda_ffn`` on the card and
``torch_reference`` on the CPU or under ``registry.forced_variant``). The
kernel wrappers :func:`group_ffn` and :func:`dropless_ffn` compute the plain
PyTorch versions (:func:`fused_group_ffn_reference`,
:func:`fused_dropless_ffn_reference`: gathered fp32 ``bmm``) on CPU tensors
and launch the kernel, or raise, on CUDA tensors. ``ff_group`` and the VMEM
budget shape the TPU kernels' W strips; they are validated as JAX does and
do not shape the CUDA schedule.

Plans are cached per topology (keyed on its ``indices`` tensor), with the
column ids already on the topology's device, so a forward reads nothing
back from the card and copies nothing to it: :func:`block_diag_topology`
(``models/moe.py``) plans from its numpy metadata when it builds the
topology.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.ops import registry

__all__ = [
    "plan_group_ffn", "fused_group_ffn", "fused_dropless_ffn", "group_ffn", "dropless_ffn",
    "fused_group_ffn_reference", "fused_dropless_ffn_reference", "plan_cols", "LAUNCHES",
]

# Kernel launches in this process, by kernel; each launch adds one.
LAUNCHES = {"bsr_ffn_group": 0, "bsr_ffn_dropless": 0}

KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Activations by name, each on fp32 (``sputnik_tpu/kernels/bsr_ffn.py:48-52``;
# "gelu" is jax.nn.gelu's default, the tanh form). The kernel's codes follow
# the dict's order.
ACTIVATIONS = {
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "relu": lambda h: torch.clamp_min(h, 0.0),
    "identity": lambda h: h,
}
_ACT_CODE = {name: i for i, name in enumerate(ACTIVATIONS)}

Plan = Tuple[np.ndarray, int]


@functools.cache
def _lib():
    lib = _build.load("bsr_ffn")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bsr_ffn_group.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.bsr_ffn_dropless.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    for fn in (lib.bsr_ffn_group, lib.bsr_ffn_dropless):
        fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------------ plans --
def _plan_from_numpy(offs: np.ndarray, idx: np.ndarray) -> Optional[Plan]:
    """``sputnik_tpu/kernels/bsr_ffn.py:55-80`` on host metadata."""
    counts = offs[1:] - offs[:-1]
    if len(counts) == 0 or counts.min() != counts.max() or counts[0] == 0:
        return None
    f_blocks = int(counts[0])
    per_row = idx.reshape(-1, f_blocks)
    # Group = run of consecutive block rows with identical column sets.
    same_as_prev = (per_row[1:] == per_row[:-1]).all(axis=1)
    starts = np.concatenate([[0], np.nonzero(~same_as_prev)[0] + 1])
    sizes = np.diff(np.concatenate([starts, [len(per_row)]]))
    if sizes.min() != sizes.max():
        return None
    return per_row[starts].astype(np.int32), int(sizes[0])


class _Entry:
    """A topology's plan and its column ids on each device they were used on."""

    def __init__(self, plan: Optional[Plan]):
        self.plan = plan
        self.cols: Dict[torch.device, torch.Tensor] = {}


_PLANS: Dict[int, Tuple[weakref.ref, _Entry]] = {}


def _entry(topology: BlockSparseMatrix) -> Optional[_Entry]:
    hit = _PLANS.get(id(topology.indices))
    return hit[1] if hit is not None and hit[0]() is topology.indices else None


def _remember(topology: BlockSparseMatrix, plan: Optional[Plan]) -> _Entry:
    key = id(topology.indices)
    entry = _Entry(plan)
    _PLANS[key] = (weakref.ref(topology.indices, lambda _: _PLANS.pop(key, None)), entry)
    if plan is not None:
        entry.cols[topology.device] = torch.as_tensor(plan[0].reshape(-1), device=topology.device)
    return entry


def remember_plan(topology: BlockSparseMatrix, offsets: np.ndarray, indices: np.ndarray) -> None:
    """Plan ``topology`` from host copies of its metadata and cache the plan,
    with its column ids on the topology's device, so that no later call
    reads the device: topology builders call this with their numpy arrays."""
    _remember(topology, _plan_from_numpy(np.asarray(offsets), np.asarray(indices)))


def plan_group_ffn(topology: BlockSparseMatrix) -> Optional[Plan]:
    """(group_cols (G, f_blocks) int32, rows_per_group) when the topology is
    group-structured, equal-size runs of block rows sharing one column
    run, else None (callers fall back to the unfused chain).

    Host-side, once per topology: the first call on metadata held on a card
    reads it back, later calls hit the cache."""
    entry = _entry(topology)
    if entry is None:
        offs = topology.offsets.cpu().numpy()
        idx = topology.indices.cpu().numpy()
        entry = _remember(topology, _plan_from_numpy(offs, idx))
    return entry.plan


def plan_cols(topology: BlockSparseMatrix, plan: Plan, device) -> torch.Tensor:
    """The plan's column ids, flat int32, on ``device`` (cached with the
    topology's plan)."""
    entry = _entry(topology)
    if entry is None or entry.plan is not plan:
        entry = _remember(topology, plan)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in entry.cols:
        entry.cols[device] = torch.as_tensor(plan[0].reshape(-1), device=device)
    return entry.cols[device]


# ---------------------------------------------------------- plain versions --
def fused_group_ffn_reference(x, w1, w2, cols, rows_per_group: int, *, bs: int = 128,
                              activation: str = "gelu", out_dtype=None):
    """Plain version of ``bsr_ffn_group``: per group, the fp32 products with
    its gathered W1 columns and W2 rows; ``h`` is rounded to x's dtype
    after the activation. ``cols`` is the flat (G * f_blocks,) column ids."""
    d = x.shape[1]
    f_blocks = cols.shape[0] // (x.shape[0] // (rows_per_group * bs))
    ids = cols.long().view(-1, f_blocks)  # (G, f)
    g = ids.shape[0]
    w1g = w1.view(d, -1, bs)[:, ids].permute(1, 0, 2, 3).reshape(g, d, f_blocks * bs)
    w2g = w2.view(-1, bs, w2.shape[1])[ids].reshape(g, f_blocks * bs, w2.shape[1])
    h = torch.bmm(x.view(g, -1, d).float(), w1g.float())
    h = ACTIVATIONS[activation](h).to(x.dtype)
    y = torch.bmm(h.float(), w2g.float())
    return y.reshape(x.shape[0], w2.shape[1]).to(out_dtype or x.dtype)


def fused_dropless_ffn_reference(x, w1, w2, expert_of_row, d_ff: int, *, tile_rows: int,
                                 activation: str = "gelu", out_dtype=None, live_rows=None):
    """Plain version of ``bsr_ffn_dropless``: per tile, the fp32 products
    with its expert's W1 columns and W2 rows. Tiles at or past
    ``live_rows`` come out as zeros (the kernel leaves them unwritten)."""
    t_pad, d = x.shape
    e = expert_of_row.long()
    n_tiles = e.shape[0]
    w1g = w1.view(d, -1, d_ff)[:, e].permute(1, 0, 2)  # (tiles, d, F)
    w2g = w2.view(-1, d_ff, w2.shape[1])[e]  # (tiles, F, d)
    h = torch.bmm(x.view(n_tiles, tile_rows, d).float(), w1g.float())
    h = ACTIVATIONS[activation](h).to(x.dtype)
    y = torch.bmm(h.float(), w2g.float())
    if live_rows is not None:
        live = torch.arange(n_tiles, device=x.device) < live_rows
        y = torch.where(live[:, None, None], y, 0.0)
    return y.reshape(t_pad, w2.shape[1]).to(out_dtype or x.dtype)


# ------------------------------------------------------- the kernel wrappers --
def _check(kernel: str, x, w1, w2, out, ff_total: int):
    for name, t in (("x", x), ("w1", w1), ("w2", w2), ("out", out)):
        if not t.is_cuda:
            raise ValueError(f"{kernel} needs CUDA tensors; {name} is on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{kernel}: operands are on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and 16-byte aligned")
    if x.dtype not in KERNEL_DTYPES or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f"{kernel} takes bf16 or fp32 operands of one dtype, got "
                         f"{x.dtype}, {w1.dtype}, {w2.dtype}")
    if out.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{kernel}: output dtype {out.dtype} not supported")
    rows, d = x.shape
    if rows % 128 or d % 128 or ff_total % 128:
        raise ValueError(f"{kernel}: rows {rows}, d_model {d} and ff_total {ff_total} "
                         "must be multiples of 128")
    if w1.shape != (d, ff_total) or w2.shape != (ff_total, d) or out.shape != x.shape:
        raise ValueError(f"{kernel}: expected w1 ({d}, {ff_total}), w2 ({ff_total}, {d}) and "
                         f"out {tuple(x.shape)}, got {tuple(w1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(out.shape)}")
    if rows // 128 > 65535:
        raise ValueError(f"{kernel}: more than 65535 block-rows")


def _int32_on(kernel: str, name: str, t: torch.Tensor, device, numel: int) -> None:
    if t.dtype != torch.int32 or t.device != device or not t.is_contiguous() or t.numel() != numel:
        raise ValueError(f"{kernel}: {name} must be {numel} contiguous int32 on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1


def launch_group(x, w1, w2, cols, rows_per_group: int, out, *, activation: str, bs: int = 128) -> None:
    """Launch ``bsr_ffn_group`` into ``out`` (x's shape, bf16 or fp32).
    ``cols``: flat (G * f_blocks,) int32 column-block ids on x's device; x
    has G * rows_per_group block-rows. Raises ``ValueError`` for what the
    kernel does not take."""
    kernel = "bsr_ffn_group"
    if bs != 128:
        raise ValueError(f"{kernel}: block size must be 128, got {bs}")
    _check(kernel, x, w1, w2, out, w1.shape[1])
    n_row_blocks = x.shape[0] // 128
    if rows_per_group < 1 or n_row_blocks % rows_per_group:
        raise ValueError(f"{kernel}: {n_row_blocks} block-rows do not split into groups of {rows_per_group}")
    n_groups = n_row_blocks // rows_per_group
    if cols.numel() % max(n_groups, 1):
        raise ValueError(f"{kernel}: {cols.numel()} column ids for {n_groups} groups")
    f_blocks = cols.numel() // max(n_groups, 1)
    _int32_on(kernel, "cols", cols, x.device, n_groups * f_blocks)
    err = _lib().bsr_ffn_group(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), cols.data_ptr(), out.data_ptr(),
        n_row_blocks, x.shape[1], w1.shape[1], f_blocks, rows_per_group,
        int(x.dtype == torch.float32), int(out.dtype == torch.float32), _ACT_CODE[activation],
        _stream(x.device),
    )
    _raise_on(kernel, err)


def launch_dropless(x, w1, w2, expert_of_row, live_rows, d_ff: int, tile_rows: int, out, *,
                    activation: str) -> None:
    """Launch ``bsr_ffn_dropless`` into ``out`` (x's shape). ``expert_of_row``:
    (t_pad // tile_rows,) int32 on x's device; ``live_rows``: a one-element
    int32 tensor on x's device, or None for all tiles live."""
    kernel = "bsr_ffn_dropless"
    _check(kernel, x, w1, w2, out, w1.shape[1])
    if d_ff % 128 or w1.shape[1] % d_ff or tile_rows % 128 or x.shape[0] % tile_rows:
        raise ValueError(f"{kernel}: d_ff {d_ff}, tile_rows {tile_rows} and x rows {x.shape[0]} must be "
                         f"multiples of 128, dividing ff_total {w1.shape[1]} and x rows")
    n_tiles = x.shape[0] // tile_rows
    _int32_on(kernel, "expert_of_row", expert_of_row, x.device, n_tiles)
    if live_rows is not None:
        _int32_on(kernel, "live_rows", live_rows, x.device, 1)
    err = _lib().bsr_ffn_dropless(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), expert_of_row.data_ptr(),
        None if live_rows is None else live_rows.data_ptr(), out.data_ptr(),
        x.shape[0] // 128, x.shape[1], w1.shape[1], d_ff // 128, tile_rows // 128,
        int(x.dtype == torch.float32), int(out.dtype == torch.float32), _ACT_CODE[activation],
        _stream(x.device),
    )
    _raise_on(kernel, err)


def group_ffn(x, w1, w2, cols, rows_per_group: int, *, bs: int = 128, activation: str = "gelu",
              out_dtype=None):
    """The kernel on CUDA tensors, its plain version on CPU ones."""
    if not x.is_cuda:
        return fused_group_ffn_reference(x, w1, w2, cols, rows_per_group, bs=bs,
                                         activation=activation, out_dtype=out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype or x.dtype, device=x.device)
    launch_group(x, w1, w2, cols, rows_per_group, out, activation=activation, bs=bs)
    return out


def dropless_ffn(x, w1, w2, expert_of_row, d_ff: int, *, tile_rows: int, activation: str = "gelu",
                 out_dtype=None, live_rows=None):
    """The kernel on CUDA tensors, its plain version on CPU ones. Output
    rows of dead tiles are unwritten on the card."""
    if not x.is_cuda:
        return fused_dropless_ffn_reference(x, w1, w2, expert_of_row, d_ff, tile_rows=tile_rows,
                                            activation=activation, out_dtype=out_dtype,
                                            live_rows=live_rows)
    out = torch.empty(x.shape, dtype=out_dtype or x.dtype, device=x.device)
    launch_dropless(x, w1, w2, expert_of_row.to(torch.int32).contiguous(),
                    None if live_rows is None else live_rows.to(torch.int32).reshape(1),
                    d_ff, tile_rows, out, activation=activation)
    return out


def _on_cuda(x, *args, **_) -> bool:
    return x.is_cuda


def _on_cpu(x, *args, **_) -> bool:
    return not x.is_cuda


registry.register("fused_group_ffn", "cuda_ffn", _on_cuda, group_ffn)
registry.register("fused_group_ffn", "torch_reference", _on_cpu, fused_group_ffn_reference)
registry.register("fused_dropless_ffn", "cuda_ffn", _on_cuda, dropless_ffn)
registry.register("fused_dropless_ffn", "torch_reference", _on_cpu, fused_dropless_ffn_reference)


# ------------------------------------------------------------ the front ends --
def fused_group_ffn(
    x: torch.Tensor,  # (G * rows_per_group * bs, d_model), group-permuted
    w1: torch.Tensor,  # (d_model, ff_total)
    w2: torch.Tensor,  # (ff_total, d_model)
    topology: BlockSparseMatrix,
    *,
    activation: str = "gelu",
    out_dtype=None,
    ff_group: Optional[int] = None,
    plan: Optional[Plan] = None,
) -> torch.Tensor:
    """y = act(SDD(x, w1, topology)) @ w2 for group-structured topologies,
    the same function as the unfused ``dsd(sdd(x, w1, topo).map(act), w2)``
    chain; raises ValueError when the topology is not group-structured
    (:func:`plan_group_ffn` pre-checks)."""
    out_dtype = out_dtype or x.dtype
    if plan is None:
        plan = plan_group_ffn(topology)
    if plan is None:
        raise ValueError(
            "fused_group_ffn needs a group-structured topology (equal-size "
            "block-row groups sharing one column run); fall back to the "
            "unfused sdd -> dsd chain"
        )
    group_cols, rows_per_group = plan
    n_groups, f_blocks = group_cols.shape
    bs = topology.block_size
    d_model = x.shape[1]
    tile_rows = rows_per_group * bs
    if x.shape[0] != n_groups * tile_rows:
        raise ValueError(f"x rows {x.shape[0]} != groups {n_groups} x {tile_rows}")
    if tuple(w1.shape) != (d_model, topology.cols):
        raise ValueError(f"w1 must be ({d_model}, {topology.cols}), got {tuple(w1.shape)}")
    if w2.shape[0] != topology.cols:
        raise ValueError(f"w2 rows {w2.shape[0]} != ff_total {topology.cols}")
    ACTIVATIONS[activation]  # an unknown name raises KeyError, as in JAX
    if ff_group is None:
        ff_group = next(g for g in (4, 2, 1) if f_blocks % g == 0)
    if f_blocks % ff_group:
        raise ValueError(f"ff_group {ff_group} must divide f_blocks {f_blocks}")
    cols = plan_cols(topology, plan, x.device)
    return registry.dispatch("fused_group_ffn", x.contiguous(), w1.contiguous(), w2.contiguous(),
                             cols, rows_per_group, bs=bs, activation=activation, out_dtype=out_dtype)


def fused_dropless_ffn(
    x: torch.Tensor,  # (t_pad, d_model), expert-grouped rows
    w1: torch.Tensor,  # (d_model, n_experts * d_ff)
    w2: torch.Tensor,  # (n_experts * d_ff, d_model)
    expert_of_row: torch.Tensor,  # (t_pad // tile_rows,) int, on x's device
    d_ff: int,
    *,
    bs: int = 128,
    tile_rows: Optional[int] = None,
    activation: str = "gelu",
    out_dtype=None,
    ff_group: Optional[int] = None,
    live_rows=None,  # int or device scalar: tiles at or past it are dead
) -> torch.Tensor:
    """Dropless MoE FFN in one kernel: the block-diagonal topology is
    data-dependent (``expert_of_row`` is rebuilt on the device every step)
    and read by the kernel, so group sizes never reach Python. Tiles at or
    past ``live_rows`` skip all compute and leave their output rows
    unwritten; callers must not read them."""
    out_dtype = out_dtype or x.dtype
    t_pad, _ = x.shape
    tr = tile_rows or bs
    if d_ff % bs:
        raise ValueError(f"d_ff {d_ff} must be a multiple of block size {bs}")
    if t_pad % tr:
        raise ValueError(
            f"x rows {t_pad} must be a multiple of tile_rows {tr} "
            "(pad the expert-grouped rows before calling)"
        )
    f_blocks = d_ff // bs
    if ff_group is not None and f_blocks % ff_group:
        raise ValueError(f"ff_group {ff_group} must divide f_blocks {f_blocks}")
    ACTIVATIONS[activation]  # an unknown name raises KeyError, as in JAX
    if tuple(expert_of_row.shape) != (t_pad // tr,):
        raise ValueError(f"expert_of_row must be ({t_pad // tr},), got {tuple(expert_of_row.shape)}")
    if live_rows is not None and not isinstance(live_rows, torch.Tensor):
        live_rows = torch.full((), int(live_rows), dtype=torch.int32, device=x.device)
    return registry.dispatch("fused_dropless_ffn", x.contiguous(), w1.contiguous(), w2.contiguous(),
                             expert_of_row, d_ff, tile_rows=tr, activation=activation,
                             out_dtype=out_dtype, live_rows=live_rows)
