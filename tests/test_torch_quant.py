"""The port's int8 quantized serving path against the JAX package, on the CPU.

The same numpy inputs go through both packages; JAX runs its Pallas kernels
in interpret mode. ``quantize`` / ``quantize_bsr`` must give the same int8
values and scales bit for bit (the fp32 division by the fp32-rounded scale,
round half to even). The int32 sums of the stream and bres kernels' plain
versions must equal JAX's kernels' exactly; scaled fp32 outputs agree
within 1e-6 relative (one fp32 multiply and cast on each side). The bres
plan must equal JAX's ``_plan``, on the host (concrete metadata) and on the
device (traced metadata). The CUDA kernels are held against their plain
versions on the card in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.kernels import bsr_dsd as jbsr_dsd
from sputnik_tpu.kernels import bsr_qstream as jbsr_qstream
from sputnik_tpu.ops import quant as jquant
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch.kernels import bsr_dsd, bsr_qstream
from sputnik_tpu_torch.models.convert import quantized_bsr_from_numpy
from sputnik_tpu_torch.ops import quant
from sputnik_tpu_torch.utils import testing

BS = 128
REL = 1e-6


def _pair(seed, rows, cols, density, **kw):
    nnz = max(int(rows * cols * density), BS * BS)
    jm = jtesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, **kw)
    tm = testing.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, device="cpu", **kw)
    return jm, tm


def _dense(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_quantize_matches_jax_bitwise(rng):
    """Random values, and values on exact halves (scale 1): round half to
    even in both."""
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5], np.float32)
    for x in (rng.standard_normal((256, 128)).astype(np.float32), ties, np.zeros(4, np.float32)):
        jq, js = jquant.quantize(jnp.asarray(x))
        tq, ts = quant.quantize(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts == js
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("per", ["tensor", "block_row"])
def test_quantize_bsr_matches_jax_bitwise(per):
    ja, ta = _pair(1, 512, 384, 0.4, unordered=True)
    gain = (10.0 ** np.random.default_rng(2).uniform(-2, 2, 4)).astype(np.float32)
    data = np.asarray(ja.data) * gain[np.asarray(ja.row_indices)][:, None, None]
    ja, ta = ja.with_data(jnp.asarray(data)), ta.with_data(torch.from_numpy(data))
    jq, js = jquant.quantize_bsr(ja, per=per)
    tq, ts = quant.quantize_bsr(ta, per=per)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(np.asarray(ts), np.asarray(js))
    with pytest.raises(ValueError, match="per must be"):
        quant.quantize_bsr(ta, per="column")


@pytest.mark.parametrize("kernel", ["stream", "bres"])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, True)])
def test_q8_int32_sums_equal_jax(rng, kernel, ta, tb):
    """The raw int32 sums of DSD and DDS, kernel by kernel."""
    m, k, n = 512, 384, 256
    ja, a = _pair(3, *((k, m) if ta else (m, k)), 1 / 3)
    jaq, sa = jquant.quantize_bsr(ja)
    aq, _ = quant.quantize_bsr(a)
    xb = rng.standard_normal((n, k) if tb else (k, n)).astype(np.float32)
    jbq, _ = jquant.quantize(jnp.asarray(xb))
    bq, _ = quant.quantize(torch.from_numpy(xb))
    jfn = {"stream": jbsr_dsd, "bres": jbsr_qstream}[kernel]
    tfn = {"stream": (bsr_dsd.dsd, bsr_dsd.dds), "bres": (bsr_qstream.dsd_bres, bsr_qstream.dds_bres)}[kernel]
    jname = {"stream": ("dsd", "dds"), "bres": ("dsd_bres", "dds_bres")}[kernel]
    kw = dict(transpose_a=ta, transpose_b=tb)
    want = getattr(jfn, jname[0])(jaq, jbq, out_dtype=jnp.int32, **kw)
    got = tfn[0](aq, bq, out_dtype=torch.int32, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # DDS: op(x) @ op(A) with A as the sparse right operand.
    xa = rng.standard_normal((m, n) if tb else (n, m)).astype(np.float32)
    jxq, _ = jquant.quantize(jnp.asarray(xa))
    xq, _ = quant.quantize(torch.from_numpy(xa))
    kw = dict(transpose_a=tb, transpose_b=ta)
    want = getattr(jfn, jname[1])(jxq, jaq, out_dtype=jnp.int32, **kw)
    np.testing.assert_array_equal(tfn[1](xq, aq, out_dtype=torch.int32, **kw).numpy(), np.asarray(want))


@pytest.mark.parametrize("kernel", ["stream", "bres"])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, True)])
def test_q8_matmuls_match_jax(rng, kernel, ta, tb):
    """matmul_dsd_q8 / matmul_dds_q8, per-tensor scales, fp32 and bf16 out
    (tests/test_quant.py's modes)."""
    m, k, n = 512, 384, 256
    ja, a = _pair(4, *((k, m) if ta else (m, k)), 1 / 3)
    jaq, jsa = jquant.quantize_bsr(ja)
    aq, sa = quant.quantize_bsr(a)
    assert sa == jsa
    jb, b = _dense(rng, (n, k) if tb else (k, n))
    jbq, jsb = jquant.quantize(jb)
    bq, sb = quant.quantize(b)
    kw = dict(transpose_a=ta, transpose_b=tb, kernel=kernel)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jquant.matmul_dsd_q8(jaq, jbq, scale_a=jsa, scale_b=jsb, out_dtype=jdt, **kw)
        got = quant.matmul_dsd_q8(aq, bq, scale_a=sa, scale_b=sb, out_dtype=tdt, **kw)
        assert got.dtype == tdt
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= (REL if tdt == torch.float32 else 2 ** -8)
    jx, x = _dense(rng, (m, n) if tb else (n, m))
    jxq, jsx = jquant.quantize(jx)
    xq, sx = quant.quantize(x)
    kw = dict(transpose_a=tb, transpose_b=ta, kernel=kernel)
    want = jquant.matmul_dds_q8(jxq, jaq, scale_a=jsx, scale_b=jsa, out_dtype=jnp.float32, **kw)
    got = quant.matmul_dds_q8(xq, aq, scale_a=sx, scale_b=sa, out_dtype=torch.float32, **kw)
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("kernel", ["stream", "bres"])
def test_q8_per_block_row_matches_jax(rng, kernel):
    m, k, n = 512, 384, 256
    ja, a = _pair(5, m, k, 1 / 3)
    gain = (10.0 ** rng.uniform(-2, 2, m // BS)).astype(np.float32)
    data = np.asarray(ja.data) * gain[np.asarray(ja.row_indices)][:, None, None]
    ja, a = ja.with_data(jnp.asarray(data)), a.with_data(torch.from_numpy(data))
    jaq, jsa = jquant.quantize_bsr(ja, per="block_row")
    aq, sa = quant.quantize_bsr(a, per="block_row")
    jb, b = _dense(rng, (k, n))
    jbq, jsb = jquant.quantize(jb)
    bq, sb = quant.quantize(b)
    want = jquant.matmul_dsd_q8(jaq, jbq, scale_a=jsa, scale_b=jsb, out_dtype=jnp.float32, kernel=kernel)
    got = quant.matmul_dsd_q8(aq, bq, scale_a=sa, scale_b=sb, out_dtype=torch.float32, kernel=kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # int32 out, then one multiply each
    with pytest.raises(ValueError, match="per-block-row"):
        quant.matmul_dsd_q8(aq, bq, scale_a=sa, scale_b=sb, transpose_a=True)


@pytest.mark.parametrize("q", [8, 4])
@pytest.mark.parametrize("transposed", [False, True])
def test_bres_plan_matches_jax(q, transposed):
    """The padded slot plan, on ragged rows with unordered columns and an
    empty block-row: the host plan against JAX's concrete plan, the device
    plan (torch ops) against JAX's traced-metadata plan."""
    ja, a = _pair(6, 1024, 768, 0.3, unordered=True)
    out_ids, dep_ids, data_ids = ja.iteration_arrays(transposed=transposed)
    offs = ja.with_transpose_metadata().offsets_t if transposed else ja.offsets
    counts = offs[1:] - offs[:-1]
    jh = jbsr_qstream._plan(*(np.asarray(x) for x in (out_ids, dep_ids, data_ids, counts)), q, concrete=True)
    jd = jbsr_qstream._plan(out_ids, dep_ids, data_ids, counts, q, concrete=False)
    host = bsr_qstream.sparse_plan(a, transposed, q)
    t_out, t_dep, t_data = a.iteration_arrays(transposed)
    t_offs = a.with_transpose_metadata().offsets_t if transposed else a.offsets
    device = bsr_qstream.plan_on_device(t_out, t_dep, t_data, t_offs[1:] - t_offs[:-1], q)
    for plan, want in ((host, jh), (device, jd)):
        for name, got, w in zip(("out_q", "dep_q", "data_q", "nv"), (plan.out_q, plan.dep_q, plan.data_q, plan.nv),
                                want):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(w), err_msg=name)
        assert plan.n_steps == want[4]
    assert device.n_steps >= host.n_steps


def test_converter_serves_jax_int8_blocks(rng):
    """JAX's quantized BSR, as numpy, through the converter: the same int8
    blocks, and the same int32 sums and scaled outputs as JAX's."""
    ja, _ = _pair(7, 512, 384, 1 / 3)
    for per in ("tensor", "block_row"):
        jq, js = jquant.quantize_bsr(ja, per=per)
        tq, ts = quantized_bsr_from_numpy(np.asarray(jq.data), np.asarray(jq.offsets), np.asarray(jq.indices),
                                          jq.shape, js if per == "tensor" else np.asarray(js), device="cpu")
        assert tq.host_known and tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
        jb, b = _dense(rng, (384, 256))
        jbq, jsb = jquant.quantize(jb)
        bq, sb = quant.quantize(b)
        want = jquant.matmul_dsd_q8(jq, jbq, scale_a=js, scale_b=jsb, out_dtype=jnp.float32)
        got = quant.matmul_dsd_q8(tq, bq, scale_a=ts, scale_b=sb, out_dtype=torch.float32)
        assert _rel(got.numpy(), want) <= REL
    with pytest.raises(ValueError, match="int8"):
        quantized_bsr_from_numpy(np.zeros((1, BS, BS), np.float32), [0, 1], [0], (BS, BS), 1.0, device="cpu")


def test_q8_rejects_float_operands():
    _, a = _pair(8, 256, 256, 0.5)
    b = torch.ones(256, 128)
    with pytest.raises(ValueError, match="int8"):
        quant.matmul_dsd_q8(a, b, scale_a=1.0, scale_b=1.0)
    aq, _ = quant.quantize_bsr(a)
    bq, _ = quant.quantize(b)
    with pytest.raises(ValueError, match="kernel must be"):
        quant.matmul_dsd_q8(aq, bq, scale_a=1.0, scale_b=1.0, kernel="panel")
