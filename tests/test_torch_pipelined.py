"""The port's pipelined DSD / DDS (``bsr_dsd.dsd`` / ``dds`` with the
launcher of ``kernels/bsr_dsd_pipelined.py``, the registry's
``cuda_pipelined``) against the JAX package's
``variant="pallas_pipelined"``, on the CPU.

The same numpy inputs go through both packages; JAX runs its Pallas kernel
in interpret mode (as ``tests/test_bsr_matmul.py::test_dsd_dds_pipelined``
does), the port the kernel's plain version (a CPU tensor takes it). fp32
agrees at atol 1e-4 / rtol 1e-5. bf16 agrees at the reference ATOL, with
inputs scaled by 1/4 so that outputs stay below ~4, where one bf16 ulp (two
fp32 sums taken in other orders may round apart) is below ATOL. The CUDA
kernel is held against the plain version on the card in
tests/test_torch_gpu.py.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import ops as jops
from sputnik_tpu.formats import BlockSparseMatrix as JBlockSparseMatrix
from sputnik_tpu.kernels import bsr_dsd_pipelined as jpipe
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import ops
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_dsd
from sputnik_tpu_torch.kernels import bsr_dsd_pipelined as pipe
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.testing import ATOL

matmul_mod = importlib.import_module("sputnik_tpu_torch.ops.matmul")

BS = 128
MODES = [(False, False), (False, True), (True, False), (True, True)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
pipe_dsd = functools.partial(bsr_dsd.dsd, launch=pipe.pipelined)
pipe_dds = functools.partial(bsr_dsd.dds, launch=pipe.pipelined)


def _tol(dtype_name):
    return dict(atol=1e-4, rtol=1e-5) if dtype_name == "float32" else dict(atol=ATOL, rtol=0)


def _scale(dtype_name):
    return 1.0 if dtype_name == "float32" else 0.25


def _pair(seed, rows, cols, density, dtype_name, **kw):
    """The same random BSR in both packages, values scaled for the dtype."""
    jdt, tdt = DTYPES[dtype_name]
    nnz = max(int(rows * cols * density), BS * BS)
    jm = jtesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, **kw)
    tm = testing.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, device="cpu", **kw)
    data = np.asarray(jm.data) * _scale(dtype_name)
    return jm.with_data(jnp.asarray(data, jdt)), tm.with_data(torch.from_numpy(data).to(tdt))


def _dense(rng, shape, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    x = rng.standard_normal(shape).astype(np.float32) * _scale(dtype_name)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dtype_name):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype_name))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_pipelined_matches_jax(rng, dtype_name, ta, tb):
    """DSD and DDS in every mode, through ``variant=`` in both registries."""
    m, k, n = 256, 384, 256
    ja, a = _pair(1, *((k, m) if ta else (m, k)), 0.5, dtype_name)
    jb, b = _dense(rng, (n, k) if tb else (k, n), dtype_name)
    want = jops.matmul_dsd(ja, jb, transpose_a=ta, transpose_b=tb, variant="pallas_pipelined")
    got = ops.matmul_dsd(a, b, transpose_a=ta, transpose_b=tb, variant="cuda_pipelined")
    assert got.dtype == DTYPES[dtype_name][1] and tuple(got.shape) == (m, n)
    _close(got, want, dtype_name)

    jd, d = _dense(rng, (k, m) if ta else (m, k), dtype_name)
    jsp, sp = _pair(2, *((n, k) if tb else (k, n)), 0.5, dtype_name)
    want = jops.matmul_dds(jd, jsp, transpose_a=ta, transpose_b=tb, variant="pallas_pipelined")
    got = ops.matmul_dds(d, sp, transpose_a=ta, transpose_b=tb, variant="cuda_pipelined")
    _close(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_pipelined_empty_rows_and_unordered_indices(dtype_name):
    """A BSR whose block-rows 1 and 3 are empty (and block-column 2), column
    indices out of order in each row: the kernel's trip count is 0 there and
    it stores zeros; DDS sees the same matrix through its transpose."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(3)
    offsets = np.array([0, 3, 3, 5, 5], np.int32)
    indices = np.array([3, 0, 1, 1, 0], np.int32)
    data = rng.standard_normal((5, BS, BS)).astype(np.float32) * _scale(dtype_name)
    ja = JBlockSparseMatrix.create(jnp.asarray(data, jdt), jnp.asarray(offsets), jnp.asarray(indices), (512, 512))
    a = BlockSparseMatrix.create(torch.from_numpy(data).to(tdt), offsets, indices, (512, 512))
    for ta in (False, True):
        jb, b = _dense(rng, (512, 256), dtype_name)
        want = jpipe.dsd(ja, jb, transpose_a=ta)
        got = pipe_dsd(a, b, transpose_a=ta)
        _close(got, want, dtype_name)
        rows = [1, 3] if not ta else [2]
        assert not got.float().reshape(4, BS, -1)[rows].any()
        jd, d = _dense(rng, (256, 512), dtype_name)
        _close(pipe_dds(d, a, transpose_b=ta), jpipe.dds(jd, ja, transpose_b=ta), dtype_name)


def test_pipelined_batch_matches_jax_per_entry(rng):
    """Sparse data with a leading batch axis of 3 and a batched dense
    operand: each entry equals JAX's call on that entry (JAX vmaps the
    kernel; the port runs the batch as one launch)."""
    ja, a = _pair(4, 384, 256, 0.4, "float32")
    data = rng.standard_normal((3,) + tuple(a.data.shape)).astype(np.float32)
    x = rng.standard_normal((3, 256, 128)).astype(np.float32)
    got = pipe_dsd(a.with_data(torch.from_numpy(data)), torch.from_numpy(x))
    got_t = pipe_dds(torch.from_numpy(x).transpose(-1, -2).contiguous(), a.with_data(torch.from_numpy(data)),
                     transpose_b=True)
    assert tuple(got.shape) == (3, 384, 128) and tuple(got_t.shape) == (3, 128, 384)
    for i in range(3):
        jai = ja.with_data(jnp.asarray(data[i]))
        want = jpipe.dsd(jai, jnp.asarray(x[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
        want_t = jpipe.dds(jnp.asarray(x[i].T), jai, transpose_b=True)
        np.testing.assert_allclose(got_t[i].numpy(), np.asarray(want_t), atol=1e-4, rtol=1e-5)


def test_pipelined_empty_matrix_is_zeros():
    """No nonzero blocks: zeros of the output shape and dtype, as JAX's; the
    launcher itself zeroes ``out`` without a launch."""
    data = np.zeros((0, BS, BS), np.float32)
    offsets, indices = np.zeros(3, np.int32), np.zeros(0, np.int32)
    ja = JBlockSparseMatrix.create(jnp.asarray(data), jnp.asarray(offsets), jnp.asarray(indices), (256, 384))
    a = BlockSparseMatrix.create(torch.from_numpy(data), offsets, indices, (256, 384))
    b = np.ones((384, 128), np.float32)
    got = pipe_dsd(a, torch.from_numpy(b), out_dtype=torch.bfloat16)
    want = jpipe.dsd(ja, jnp.asarray(b), out_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape) == (256, 128)
    assert not got.any()
    got = pipe_dds(torch.ones(64, 256), a)
    assert tuple(got.shape) == tuple(jpipe.dds(jnp.ones((64, 256)), ja).shape) == (64, 384) and not got.any()
    before = pipe.LAUNCHES
    out = torch.ones(256, 128)
    pipe.pipelined(a, torch.from_numpy(b), out, transpose_sparse=False, transpose_dense=False, out_transposed=False)
    assert not out.any() and pipe.LAUNCHES == before


def test_pipelined_checks_contraction():
    _, a = _pair(5, 256, 256, 0.5, "float32")
    with pytest.raises(ValueError, match="contraction mismatch"):
        ops.matmul_dsd(a, torch.zeros(384, 128), variant="cuda_pipelined")
    with pytest.raises(ValueError, match="contraction mismatch"):
        ops.matmul_dds(torch.zeros(128, 384), a, variant="cuda_pipelined")


def test_pipelined_launcher_refuses_cpu_and_dtypes():
    """The launcher takes CUDA tensors of bf16 or fp32 only and no
    ``out_scale``; a CPU tensor, an int8 operand or a scale raises before
    any launch."""
    _, a = _pair(6, 256, 256, 0.5, "float32")
    out = torch.empty(256, 128)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pipe.pipelined(a, torch.zeros(256, 128), out, transpose_sparse=False, transpose_dense=False,
                       out_transposed=False)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        pipe._check_dtypes(torch.int8, torch.int8, torch.float32)
    with pytest.raises(ValueError, match="output dtype"):
        pipe._check_dtypes(torch.float32, torch.float32, torch.int32)
    with pytest.raises(ValueError, match="no out_scale"):
        pipe.pipelined(a, torch.zeros(256, 128), out, transpose_sparse=False, transpose_dense=False,
                       out_transposed=False, out_scale=2.0)


def test_pipelined_registered_after_bres_and_first_fit_unchanged(monkeypatch, rng):
    """``cuda_pipelined`` sits where JAX's ``pallas_pipelined`` sits relative
    to the port's variants (after the bres pair, and right after
    ``cuda_panel``, as JAX's follows ``pallas_panel``; before the small-block
    kernel) with the stream kernel's predicate; with the device predicates
    reporting CUDA, first fit still names ``cuda_stream`` for DSD and DDS."""
    for op, before in (("dsd", "cuda_panel"), ("dds", "cuda_panel")):
        names = [v.name for v in registry._REGISTRY[op]]
        i = names.index("cuda_pipelined")
        assert names[i - 1] == before and names[i + 1] == "cuda_smallblock"
        assert names.index("cuda_bres_q4") < i
        assert names.index("cuda_stream") < i
    monkeypatch.setattr(matmul_mod, "_on_cuda", lambda *xs: True)
    _, a = _pair(7, 512, 512, 0.25, "bfloat16")
    _, b = _dense(rng, (512, 256), "bfloat16")
    assert registry.dispatch_name("dsd", a, b) == "cuda_stream"
    assert registry.dispatch_name("dds", b.T.contiguous(), a) == "cuda_stream"
    pipelined = next(v for v in registry._REGISTRY["dsd"] if v.name == "cuda_pipelined")
    assert pipelined.can_implement(a, b) and not pipelined.can_implement(a.astype(torch.int8), b)
