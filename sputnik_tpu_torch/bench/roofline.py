"""Per-kernel roofline audit on the card (``sputnik_tpu/bench/roofline.py``).

For each of the JAX audit's 22 rows, in its order and on its inputs (seed
7): the JAX package's analytic flops / bytes / element-op model, the
measured device time (``utils/profiling.py::device_time``: 100 calls
replayed from a CUDA graph), and the fraction of the speed of light
``sol_t = max(flops / peak, bytes / bandwidth, element ops / CUDA-core
rate)`` (``bench/models.py``). The peaks are the H100 data sheet's
(``models.PEAKS``); ``frac_achievable`` scales them by the peaks measured
on this card at this power limit (``calibrate.load_measured_peaks``), when
there are any. Each row names the variant that ran: ``registry.dispatch_name``
for the BSR matmuls, and for the other rows the kernels whose launch counts
one call of the row raised (:func:`launched`; a row that launches none is
an error row). A time under 3
us publishes its fraction as ``frac_sol_unreliable``, as JAX's does. A
fraction above 1.05 is impossible and raises.

Run:  python -m sputnik_tpu_torch.bench.roofline [--d 2048] [--density 0.25]
      [--dtype bfloat16] [--out FILE]
Prints the markdown table and writes the rows to
``sputnik_tpu_torch/bench/results/roofline_audit.json`` or ``--out`` (not
``docs/``, which holds the JAX package's TPU records). Needs a CUDA card;
:func:`row_plan` builds the rows without timing them, on any device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from sputnik_tpu_torch.bench.models import (
    PEAKS, VPU_ELEM_OPS, dsd_model, dss_flat_model, sdd_model, sell_vpu_elems, softmax_model, sol_time,
    sparse_out_flat_model,
)

SOL_LIMIT = 1.05
NOISE_FLOOR_US = 3.0


@dataclasses.dataclass
class Row:
    """One audit row before it is timed: ``fn(*args)`` and its model."""

    op: str
    fn: Callable
    args: tuple
    flops: float
    bytes: float
    vpu: float = 0
    peak_flops: Optional[float] = None  # None: the dtype's peak
    variant: Optional[Callable[[], str]] = None  # None: the kernels one call launches


def launch_counts() -> dict:
    """The launch counts of the kernels the audit's rows past the
    registry's reach, by kernel."""
    from sputnik_tpu_torch.kernels import bsr_dsd, bsr_qstream, bsr_softmax, flash_mha, sell

    return {"bsr_dsd_stream": bsr_dsd.LAUNCHES, "bsr_dsd_stream_q8": bsr_dsd.LAUNCHES_Q8,
            "bsr_bres": bsr_qstream.LAUNCHES, **bsr_softmax.LAUNCHES, **sell.LAUNCHES, **flash_mha.LAUNCHES}


def launched(r: Row) -> str:
    """The kernels one call of ``r`` launched, read from their counts before
    and after it; raises when it launched none of them."""
    before = launch_counts()
    r.fn(*r.args)
    after = launch_counts()
    ran = [k for k in after if after[k] > before[k]]
    if not ran:
        raise RuntimeError(f"{r.op}: one call launched none of {sorted(after)}")
    return " + ".join(ran)


def _dense(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


def row_plan(d: int = 2048, density: float = 0.25, dtype_name: str = "bfloat16", device=None, peaks=PEAKS):
    """The JAX audit's rows, in its order, on its inputs (seed 7, drawn in
    its order) and with its models; nothing is timed. ``device=None``
    builds on the card."""
    from sputnik_tpu_torch import ops
    from sputnik_tpu_torch.formats import SellMatrix
    from sputnik_tpu_torch.kernels import sell as sell_kernels
    from sputnik_tpu_torch.models import attention as attn_lib
    from sputnik_tpu_torch.ops import csr as csr_ops
    from sputnik_tpu_torch.ops import quant, registry
    from sputnik_tpu_torch.ops.softmax import bsr_softmax, sdd_softmax
    from sputnik_tpu_torch.utils import testing
    from sputnik_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dtype = getattr(torch, dtype_name)
    isz = torch.empty((), dtype=dtype).element_size()
    rng = np.random.default_rng(7)
    a = testing.random_bsr(rng, d, d, int(d * d * density), 128, dtype=dtype, device=dev)
    b = _dense(rng, (d, d), dtype, dev)
    topo = testing.random_bsr(rng, d, d, int(d * d * density), 128, dtype=dtype, device=dev)
    nnz, nnz_b = a.nnz_blocks * 128 * 128, a.nnz_blocks
    rows = []

    def add(op, fn, args, flops, bytes_moved, *, vpu=0, pf=None, variant=None):
        rows.append(Row(op, fn, args, flops, bytes_moved, vpu, pf, variant))

    def name_of(op, *args, **kw):
        return lambda: registry.dispatch_name(op, *args, **kw)

    a_tcols = len(np.unique(a.host_indices))
    dsd_f, dsd_by = dsd_model(nnz=nnz, nnz_blocks=nnz_b, m=d, n=d, k=d, isz=isz, touched_deps=a_tcols)
    add("bsr_dsd", lambda a_, b_: ops.matmul_dsd(a_, b_), (a, b), dsd_f, dsd_by, variant=name_of("dsd", a, b))
    add("bsr_dds", lambda b_, m_: ops.matmul_dds(b_, m_), (b, a), dsd_f, dsd_by, variant=name_of("dds", b, a))
    add("bsr_dds(ct)", lambda b_, m_: ops.matmul_dds(b_, m_, variant="cuda_ct"), (b, a), dsd_f, dsd_by,
        variant=lambda: "cuda_ct")
    out_isz = isz
    add("bsr_dsd(bres)", lambda a_, b_: ops.matmul_dsd(a_, b_, variant="cuda_bres"), (a, b), dsd_f,
        nnz * isz + d * d * isz + d * d * out_isz, variant=lambda: "cuda_bres")
    add("bsr_dsd(kcat_q8)", lambda a_, b_: ops.matmul_dsd(a_, b_, variant="cuda_qstream_kcat_q8"), (a, b), dsd_f,
        dsd_by, variant=lambda: "cuda_qstream_kcat_q8")
    # int8 (the serving path): the int8 peak; the bf16 model at isz 1 with a
    # bf16 output.
    int8_peak = peaks.get("int8_ops", 2 * peaks["bf16_flops"])
    a_q, s_a = quant.quantize_bsr(a)
    b_q, s_b = quant.quantize(b)
    q_f, q_by = dsd_model(nnz=nnz, nnz_blocks=nnz_b, m=d, n=d, k=d, isz=1, touched_deps=a_tcols)
    q_by += d * d
    for kname in ("stream", "bres"):
        add(f"bsr_dsd_q8({kname})",
            lambda a_, b_, _k=kname: quant.matmul_dsd_q8(a_, b_, scale_a=s_a, scale_b=s_b, kernel=_k),
            (a_q, b_q), q_f, q_by if kname == "stream" else nnz + d * d + d * d * out_isz, pf=int8_peak)
    add("bsr_dds_q8(stream)", lambda b_, m_: quant.matmul_dds_q8(b_, m_, scale_a=s_b, scale_b=s_a), (b_q, a_q),
        q_f, q_by, pf=int8_peak)
    sdd_f, sdd_by = sdd_model(nnz=topo.nnz_blocks * 128 * 128, nnz_blocks=topo.nnz_blocks, m=d, n=d, k=d, isz=isz,
                              touched_rows=len(np.unique(topo.host_row_indices())),
                              touched_cols=len(np.unique(topo.host_indices)))
    add("bsr_sdd", lambda x_, y_: ops.matmul_sdd(x_, y_, topo).data, (b, b), sdd_f, sdd_by,
        variant=name_of("sdd", b, b, topo))
    add("bsr_sdd(bres)", lambda x_, y_: ops.matmul_sdd(x_, y_, topo, transpose_b=True, variant="cuda_bres").data,
        (b, b), sdd_f, 2 * d * d * isz + topo.nnz_blocks * 128 * 128 * isz, variant=lambda: "cuda_bres")
    # SSD / SDS / DSS / SSS on their exact work lists, planned once.
    topo_nnz = topo.nnz_blocks * 128 * 128
    ssd_sched, sds_sched, dss_sched = ops.plan_ssd(a, topo), ops.plan_sds(a, topo), ops.plan_dss(a, topo)
    ssd_f, ssd_by = sparse_out_flat_model(total_items=ssd_sched.total, nnz_out=topo_nnz, isz=isz)
    add("bsr_ssd", lambda a_, b_: ops.matmul_ssd(a_, b_, topo, schedule=ssd_sched).data, (a, b), ssd_f, ssd_by,
        variant=name_of("ssd", a, b, topo, schedule=ssd_sched))
    sds_f, sds_by = sparse_out_flat_model(total_items=sds_sched.total, nnz_out=topo_nnz, isz=isz)
    add("bsr_sds", lambda b_, m_: ops.matmul_sds(b_, m_, topo, schedule=sds_sched).data, (b, a), sds_f, sds_by,
        variant=name_of("sds", b, a, topo, schedule=sds_sched))
    dss_f, dss_by = dss_flat_model(total_items=dss_sched.total, m=d, n=d, isz=isz)
    add("bsr_dss", lambda a_, b_: ops.matmul_dss(a_, b_, schedule=dss_sched), (a, topo), dss_f, dss_by,
        variant=name_of("dss", a, topo, schedule=dss_sched))
    sss_topo = testing.random_bsr(rng, d, d, int(d * d * density / 2), 128, dtype=dtype, device=dev)
    sss_sched = ops.plan_sss(a, topo, sss_topo)
    if sss_sched.total:
        sss_f, sss_by = sparse_out_flat_model(total_items=sss_sched.total, nnz_out=sss_topo.nnz_blocks * 128 * 128,
                                              isz=isz)
        add("bsr_sss", lambda a_, b_: ops.matmul_sss(a_, b_, sss_topo, schedule=sss_sched).data, (a, topo), sss_f,
            sss_by, variant=name_of("sss", a, topo, sss_topo, schedule=sss_sched))
    sm_f, sm_by = softmax_model(nnz=nnz, isz=isz)
    add("bsr_softmax", lambda m_: bsr_softmax(m_).data, (a,), sm_f, sm_by, vpu=8 * nnz)
    qsm = _dense(rng, (d, 128), dtype, dev)
    sm2_f = 2 * topo_nnz * 128 + 5 * topo_nnz
    sm2_by = 2 * topo.nnz_blocks * 128 * 128 * isz + 2 * topo_nnz * 4 + topo_nnz * isz
    add("sdd_softmax(fused)", lambda q_, k_: sdd_softmax(q_, k_, topo).data, (qsm, qsm + 0.1), sm2_f, sm2_by,
        vpu=8 * topo_nnz)

    # The CSR engine (SELL) at the audit's width: compulsory bytes, and the
    # TPU kernels' select-reconstruct element ops as JAX's model charges them.
    c = testing.random_csr(rng, d, d, int(d * d * 0.1), dtype=torch.float32, device=dev)
    s_mat = SellMatrix.from_csr(c)
    s_slots = int(s_mat.tile_widths.sum())
    nnz_e = int(d * d * 0.1)
    bn = 256
    bm = _dense(rng, (d, bn), torch.float32, dev)
    spmm_bytes = nnz_e * 8 + 2 * d * bn * 4
    add("csr_spmm(sell)", lambda c_, b_: csr_ops.spmm(c_, b_), (s_mat, bm), 2 * nnz_e * bn, spmm_bytes,
        vpu=sell_vpu_elems(s_slots, s_mat.chunk))
    qm = _dense(rng, (d, 64), torch.float32, dev)
    km = _dense(rng, (d, 64), torch.float32, dev)
    ctopo = SellMatrix.from_csr(testing.random_csr(rng, d, d, int(d * d * 0.05), dtype=torch.float32, device=dev))
    ct_slots = int(ctopo.tile_widths.sum())
    nnz_t = int(d * d * 0.05)
    add("csr_sddmm(sell)", lambda q_, k_: csr_ops.sddmm(q_, k_, ctopo).values, (qm, km), 2 * nnz_t * 64,
        nnz_t * 8 + 2 * d * 64 * 4 + nnz_t * 4, vpu=sell_vpu_elems(ct_slots, ctopo.chunk))
    add("csr_softmax(sell)", lambda c_: csr_ops.sparse_softmax(c_).values, (s_mat,), 5 * nnz_e, 2 * nnz_e * 4,
        vpu=5 * s_mat.n_chunks * s_mat.width * s_mat.rows_padded)
    xg = _dense(rng, (d, bn), torch.float32, dev)
    add("csr_spmm_t(sell)", lambda s_, x_: sell_kernels.spmm_t(s_, x_), (s_mat, xg), 2 * nnz_e * bn, spmm_bytes,
        vpu=sell_vpu_elems(s_slots, s_mat.chunk))

    # Fused flash attention on a causal band of 8 blocks, one head and 8.
    ftopo = attn_lib.causal_block_topology(d, 128, window_blocks=8, dtype=dtype, device=dev)
    dh = 128
    qf = _dense(rng, (d, dh), dtype, dev)
    f_flops = 4 * ftopo.nnz_blocks * 128 * 128 * dh
    f_bytes = ftopo.nnz_blocks * 2 * 128 * dh * isz + 2 * d * dh * isz
    add("flash_block_attention",
        lambda q_, k_, v_: attn_lib.block_sparse_attention(q_, k_, v_, ftopo, causal=True, fused=True),
        (qf, qf + 0.1, qf - 0.1), f_flops, f_bytes, vpu=6 * ftopo.nnz_blocks * 128 * 128)
    heads = 8
    qh = _dense(rng, (heads, d, dh), dtype, dev)
    add("flash_mha(8h)",
        lambda q_, k_, v_: attn_lib.multihead_block_sparse_attention(q_, k_, v_, ftopo, causal=True, fused=True),
        (qh, qh + 0.1, qh - 0.1), heads * f_flops,
        heads * (ftopo.nnz_blocks * 2 * 128 * dh * isz + 2 * d * dh * isz), vpu=6 * heads * ftopo.nnz_blocks * 128 * 128)
    return rows


def audit(d: int = 2048, density: float = 0.25, dtype_name: str = "bfloat16", peaks=PEAKS) -> list:
    """Time every row of :func:`row_plan` on the card; a row whose call
    raises is kept as ``{"op", "error"}``."""
    from sputnik_tpu_torch.bench.calibrate import load_measured_peaks
    from sputnik_tpu_torch.utils.profiling import device_time

    if not torch.cuda.is_available():
        raise RuntimeError("the roofline audit needs a CUDA card: torch.cuda.is_available() is false")
    dtype = getattr(torch, dtype_name)
    peak_flops = peaks["bf16_flops"] if dtype == torch.bfloat16 else peaks["f32_flops"]
    bw = peaks["hbm_bps"]
    measured = load_measured_peaks()
    out = []
    for r in row_plan(d, density, dtype_name, peaks=peaks):
        start = time.perf_counter()
        pf = peak_flops if r.peak_flops is None else r.peak_flops
        try:
            variant = r.variant() if r.variant is not None else launched(r)
            m = device_time(r.fn, *r.args)
        except Exception as e:  # noqa: BLE001 - record the failure, keep auditing
            out.append({"op": r.op, "error": f"{type(e).__name__}: {str(e)[:160]}"})
            continue
        t = m["time_s"]
        sol = sol_time(r.flops, r.bytes, peak_flops=pf, hbm_bps=bw, vpu_elems=r.vpu)
        bound = "compute"
        if sol == r.bytes / bw:
            bound = "bandwidth"
        if r.vpu and sol == r.vpu / VPU_ELEM_OPS:
            bound = "vpu"
        row = {"op": r.op, "variant": variant, "time_us": t * 1e6, "gflops": r.flops / t / 1e9, "flops": r.flops,
               "bytes": r.bytes, "vpu_elems": r.vpu, "bound": bound, "sol_us": sol * 1e6, "timing": m["timing"]}
        if t * 1e6 < NOISE_FLOOR_US:
            row["frac_sol_unreliable"] = sol / t
            row["note"] = "sub-3us: below the timing's noise floor"
        else:
            if sol / t > SOL_LIMIT:
                raise RuntimeError(f"impossible reading: {r.op} at {sol / t:.3f} of the speed of light "
                                   f"({t * 1e6:.2f} us against a bound of {sol * 1e6:.2f} us)")
            row["frac_sol"] = sol / t
            if measured:
                eff = measured["mxu_efficiency" if pf != peaks["f32_flops"] else "f32_efficiency"]
                sol_a = sol_time(r.flops, r.bytes, peak_flops=pf * eff, hbm_bps=bw * measured["hbm_efficiency"],
                                 vpu_elems=r.vpu)
                row["frac_achievable"] = sol_a / t
        out.append(row)
        print(f"[roofline] {r.op}: {t * 1e6:.2f} us ({time.perf_counter() - start:.1f} s to measure)", file=sys.stderr,
              flush=True)
    return out


def table(rows, d: int, density: float, dtype_name: str, card_name: str) -> str:
    lines = [f"# Roofline audit: d={d}, density={density}, {dtype_name}, on {card_name}", "",
             "| op | variant | time (us) | GFLOP/s | bound | frac of SoL | frac achv | timing |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['op']} | ERROR: {r['error']} | | | | | | |")
            continue
        achv = f"{r['frac_achievable']:.4f}" if "frac_achievable" in r else "—"
        frac = f"{r['frac_sol']:.4f}" if "frac_sol" in r else f"({r['frac_sol_unreliable']:.4f})"
        lines.append(f"| {r['op']} | {r['variant']} | {r['time_us']:.2f} | {r['gflops']:.0f} | {r['bound']} | "
                     f"{frac} | {achv} | {r['timing']} |")
    return "\n".join(lines)


def main(argv=None):
    from sputnik_tpu_torch.bench.calibrate import RESULTS
    from sputnik_tpu_torch.utils.profiling import card

    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=2048)
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--out", default=os.path.join(RESULTS, "roofline_audit.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.roofline needs a CUDA card: torch.cuda.is_available() is false")
    name = card()
    rows = audit(args.d, args.density, args.dtype)
    print(table(rows, args.d, args.density, args.dtype, name))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "card": name, "d": args.d, "density": args.density,
                   "dtype": args.dtype, "rows": rows}, f, indent=2)
    print(f"\n(written to {args.out})", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
