"""Analytic flops / bytes models of the BSR ops and the speed of light
(``sputnik_tpu/bench/models.py``), with the H100's peaks.

One place for the accounting that ``bench/dsd.py``, ``bench/roofline.py``
and ``chip_smoke.py`` divide by, so every published fraction measures
against the same definition. The formulas are the JAX
package's, function for function (held equal by
``tests/test_torch_bench.py``): the byte models are reuse-aware, with the
streamed dense-operand traffic floored at each touched tile read once per
panel pass, so ``sol_time / t <= ~1``.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit: bf16 on
# the tensor cores, fp32 on the CUDA cores (no TF32), int8 on the tensor
# cores, HBM3 bandwidth.
PEAKS = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bps": 3.35e12, "int8_ops": 1979e12}
# Element-op rate of the CUDA cores (what JAX's VPU_ELEM_OPS is to the
# TPU's vector unit): 132 SMs x 128 fp32 lanes x 1.98 GHz boost clock =
# 33.5e12 element ops/s, half the fp32 FLOP rate (an FMA is two FLOPs and
# one element op). Softmax-like ops (exp, compare, select) meet this wall
# before HBM on some shapes.
VPU_ELEM_OPS = 132 * 128 * 1.98e9


def dsd_model(*, nnz: int, nnz_blocks: int, m: int, n: int, k: int,
              isz: int, bs: int = 128, n_tile: int = 4096,
              touched_deps: int | None = None):
    """dense[M,N] = sparse[M,K] @ dense[K,N] (or any transpose thereof).

    Per nonzero block the kernel gathers one (bs, bn) panel of the dense
    operand; the floor is each TOUCHED panel tile once per panel pass (a
    dense strip adjacent to no nonzero block is never read).
    ``touched_deps`` = distinct contraction-block ids among the nonzero
    blocks; None = all k / bs touched. The output floor is the full M x N:
    rows with no blocks are zeroed. With ``n_tile >= n`` there is one pass,
    and the model is the same for every implementation."""
    flops = 2 * nnz * n
    bn = min(n_tile, n)
    n_passes = -(-n // bn)
    td = k // bs if touched_deps is None else touched_deps
    per_pass_stream = nnz_blocks * bs * bn * isz
    per_pass_floor = td * bs * bn * isz  # every TOUCHED (bs, bn) tile once
    bytes_moved = (
        min(per_pass_stream, max(per_pass_floor, bs * bn * isz)) * n_passes
        + nnz * isz * n_passes  # sparse blocks stream once per pass
        + m * n * isz  # output
    )
    return flops, bytes_moved


def sdd_model(*, nnz: int, nnz_blocks: int, m: int, n: int, k: int,
              isz: int, bs: int = 128,
              touched_rows: int | None = None,
              touched_cols: int | None = None):
    """sparse_out = dense @ dense at the output topology: per output block
    one (bs, K) strip of each input; the floor is each TOUCHED input strip
    read once. ``touched_rows`` / ``touched_cols``: the distinct block-row /
    block-column counts of the topology; None = all touched."""
    flops = 2 * nnz * k
    tr = m // bs if touched_rows is None else touched_rows
    tc = n // bs if touched_cols is None else touched_cols
    stream_a = min(nnz_blocks * bs * k, tr * bs * k) * isz
    stream_b = min(nnz_blocks * bs * k, tc * bs * k) * isz
    return flops, stream_a + stream_b + nnz * isz


def sparse_out_flat_model(*, total_items: int, nnz_out: int, isz: int,
                          bs: int = 128):
    """SSD / SDS through an exact work list: per item one sparse block and
    one (bs, bs) dense tile in; the packed output written once."""
    flops = 2 * total_items * bs ** 3
    bytes_moved = total_items * (2 * bs * bs * isz) + nnz_out * isz
    return flops, bytes_moved


def dss_flat_model(*, total_items: int, m: int, n: int, isz: int,
                   bs: int = 128):
    flops = 2 * total_items * bs ** 3
    bytes_moved = total_items * (2 * bs * bs * isz) + m * n * isz
    return flops, bytes_moved


def softmax_model(*, nnz: int, isz: int):
    """Two passes (row max, then exp / normalize): the data read twice and
    written once."""
    return 5 * nnz, 3 * nnz * isz


def sol_time(flops: int, bytes_moved: int, *, peak_flops: float,
             hbm_bps: float, vpu_elems: int = 0) -> float:
    """The least time: the largest of the operations at ``peak_flops``, the
    bytes at ``hbm_bps`` and the element ops at :data:`VPU_ELEM_OPS`."""
    return max(
        flops / peak_flops,
        bytes_moved / hbm_bps,
        vpu_elems / VPU_ELEM_OPS,
    )


def sell_vpu_elems(slots_total: int, chunk: int, tr: int = 128,
                   ops_per_slot: int = 3) -> int:
    """The TPU SELL kernels' select-reconstruct work: ~3 full (chunk, TR)
    panel ops per slot, however few values it places. The port's SELL
    kernels gather instead (Sputnik's shape), so no bound of theirs
    charges any of it."""
    return ops_per_slot * slots_total * chunk * tr
