"""The port's q-stream, C-resident, group-resident and input-resident SDD
schedules (``kernels/bsr_qstream.py`` ``dsd_q`` / ``dds_q`` / ``dds_ct``,
``kernels/bsr_cres.py``, ``kernels/bsr_sdd.py`` ``sdd_bres``) against the
JAX package's, on the CPU.

The same numpy inputs go through both packages; JAX runs its Pallas kernels
in interpret mode (``tests/conftest.py``), the port its kernels' plain
versions on the same plans (a CPU tensor takes them). Plans and metadata
agree exactly; fp32 values at atol 1e-4 / rtol 1e-5, bf16 at the reference
ATOL (inputs scaled by 1/4, so that one bf16 ulp of an output stays below
it), and both against the fp64 oracle. The CUDA kernels are held against
the plain versions on the card in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.formats import BlockSparseMatrix as JBlockSparseMatrix
from sputnik_tpu.kernels import bsr_cres as jcres
from sputnik_tpu.kernels import bsr_qstream as jqstream
from sputnik_tpu.kernels import bsr_sdd as jsdd
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_cres, bsr_qstream, bsr_sdd
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.testing import ATOL

BS = 128
MODES = [(False, False), (False, True), (True, False), (True, True)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# JAX's test shape (tests/test_bsr_matmul.py::test_cres_gres_schedules).
M, K, N = 640, 384, 512


def _tol(dtype_name):
    return dict(atol=1e-4, rtol=1e-5) if dtype_name == "float32" else dict(atol=ATOL, rtol=0)


def _scale(dtype_name):
    return 1.0 if dtype_name == "float32" else 0.25


def _pair(seed, rows, cols, density, dtype_name="float32", **kw):
    """The same random BSR in both packages, values scaled for the dtype."""
    jdt, tdt = DTYPES[dtype_name]
    nnz = max(int(rows * cols * density), BS * BS)
    jm = jtesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, **kw)
    tm = testing.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, device="cpu", **kw)
    data = np.random.default_rng(seed + 100).standard_normal(tuple(jm.data.shape)).astype(np.float32)
    data *= _scale(dtype_name)
    return jm.with_data(jnp.asarray(data, jdt)), tm.with_data(torch.from_numpy(data).to(tdt))


def _dense(rng, shape, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    x = rng.standard_normal(shape).astype(np.float32) * _scale(dtype_name)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _check(got, want, dtype_name, oracle):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype_name))
    np.testing.assert_allclose(got.float().numpy(), oracle, **_tol(dtype_name))


def _dsd_problem(rng, dtype_name, ta, tb, seed=1, density=0.3):
    ja, a = _pair(seed, *((K, M) if ta else (M, K)), density, dtype_name, unordered=True)
    jb, b = _dense(rng, (N, K) if tb else (K, N), dtype_name)
    oracle = testing.dense_oracle_matmul(np.asarray(ja.to_dense(), np.float32), np.asarray(jb, np.float32),
                                         transpose_a=ta, transpose_b=tb)
    return ja, a, jb, b, oracle


def _dds_problem(rng, dtype_name, ta, tb, seed=2, density=0.3):
    jsp, sp = _pair(seed, *((N, K) if tb else (K, N)), density, dtype_name, unordered=True)
    jd, d = _dense(rng, (K, M) if ta else (M, K), dtype_name)
    oracle = testing.dense_oracle_matmul(np.asarray(jd, np.float32), np.asarray(jsp.to_dense(), np.float32),
                                         transpose_a=ta, transpose_b=tb)
    return jd, d, jsp, sp, oracle


# ------------------------------------------------------------------ plans --
@pytest.mark.parametrize("q", [2, 8])
@pytest.mark.parametrize("transposed", [False, True])
def test_qstream_plan_matches_jax(q, transposed):
    """The q-stream's padded slot plan of host-known metadata, JAX's
    concrete ``_plan`` element for element (the card-built plan is held in
    tests/test_torch_quant.py)."""
    ja, a = _pair(3, 768, 512, 0.3, unordered=True)
    out_ids, dep_ids, data_ids = (np.asarray(x) for x in ja.iteration_arrays(transposed=transposed))
    offs = np.asarray(ja.with_transpose_metadata().offsets_t if transposed else ja.offsets)
    want = jqstream._plan(out_ids, dep_ids, data_ids, np.diff(offs), q, concrete=True)
    got = bsr_qstream.sparse_plan(a, transposed, q)
    for name, x, y in zip(("out_q", "dep_q", "data_q", "nv"), want[:4], (got.out_q, got.dep_q, got.data_q, got.nv)):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=name)
    assert got.n_steps == want[4]


@pytest.mark.parametrize("op_transposed", [False, True])
def test_dep_major_arrays_match_jax(op_transposed):
    ja, a = _pair(4, 640, 384, 0.3, unordered=True)
    want = jcres._dep_major_arrays(ja, op_transposed)
    got = bsr_cres._dep_major_arrays(a, op_transposed)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("group_rows", [1, 2, 4])
@pytest.mark.parametrize("op_transposed", [False, True])
def test_plan_gres_matches_jax(op_transposed, group_rows):
    """``plan_gres``'s arrays and sizes, and ``_pick_group_rows``, equal JAX's."""
    ja, a = _pair(5, 640, 384, 0.3, unordered=True)
    want = jcres.plan_gres(ja, op_transposed=op_transposed, group_rows=group_rows)
    got = bsr_cres.plan_gres(a, op_transposed=op_transposed, group_rows=group_rows)
    for x, y in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(y, np.asarray(x))
        assert y.dtype == np.int32
    assert got[4:] == tuple(want[4:])
    for out_blocks, other in ((5, 512), (16, 2048), (32, 4096), (128, 16384), (64, 65536)):
        assert bsr_cres._pick_group_rows(out_blocks, other, BS) == jcres._pick_group_rows(out_blocks, other, BS)


@pytest.mark.parametrize("pack", [1, 2, 4])
def test_plan_sdd_bres_matches_jax(pack):
    jt, t = _pair(6, 640, 768, 0.3, unordered=True)
    want = jsdd.plan_sdd_bres(jt, pack)
    got = bsr_sdd.plan_sdd_bres(t, pack)
    for x, y in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(y, np.asarray(x))
    assert got[3] == want[3]


# ----------------------------------------------------------------- values --
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_qstream_matches_jax(rng, dtype_name, ta, tb):
    """dsd_q (q 4 and 2), dds_q and dds_ct against JAX's in every mode."""
    ja, a, jb, b, oracle = _dsd_problem(rng, dtype_name, ta, tb)
    for q, accum in ((4, "ref"), (2, "kcat")):
        want = jqstream.dsd_q(ja, jb, transpose_a=ta, transpose_b=tb, q=q, accum=accum)
        got = bsr_qstream.dsd_q(a, b, transpose_a=ta, transpose_b=tb, q=q, accum=accum)
        assert got.dtype == DTYPES[dtype_name][1] and tuple(got.shape) == (M, N)
        _check(got, want, dtype_name, oracle)
    jd, d, jsp, sp, oracle = _dds_problem(rng, dtype_name, ta, tb)
    _check(bsr_qstream.dds_q(d, sp, transpose_a=ta, transpose_b=tb, accum="value"),
           jqstream.dds_q(jd, jsp, transpose_a=ta, transpose_b=tb, accum="value"), dtype_name, oracle)
    _check(bsr_qstream.dds_ct(d, sp, transpose_a=ta, transpose_b=tb),
           jqstream.dds_ct(jd, jsp, transpose_a=ta, transpose_b=tb), dtype_name, oracle)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_cres_gres_match_jax(rng, dtype_name, ta, tb):
    """dsd_cres / dds_cres and dsd_gres / dds_gres (the picked group size
    and group_rows=2) against JAX's in every mode."""
    ja, a, jb, b, oracle = _dsd_problem(rng, dtype_name, ta, tb)
    kw = dict(transpose_a=ta, transpose_b=tb)
    _check(bsr_cres.dsd_cres(a, b, **kw), jcres.dsd_cres(ja, jb, **kw), dtype_name, oracle)
    _check(bsr_cres.dsd_gres(a, b, group_rows=2, **kw), jcres.dsd_gres(ja, jb, group_rows=2, **kw), dtype_name,
           oracle)
    jd, d, jsp, sp, oracle = _dds_problem(rng, dtype_name, ta, tb)
    _check(bsr_cres.dds_cres(d, sp, **kw), jcres.dds_cres(jd, jsp, **kw), dtype_name, oracle)
    _check(bsr_cres.dds_gres(d, sp, **kw), jcres.dds_gres(jd, jsp, **kw), dtype_name, oracle)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_sdd_bres_matches_jax(rng, dtype_name, ta, tb):
    jt, t = _pair(7, 384, 512, 0.4, dtype_name, unordered=True)
    ja, a = _dense(rng, (K, 384) if ta else (384, K), dtype_name)
    jb, b = _dense(rng, (512, K) if tb else (K, 512), dtype_name)
    want = jsdd.sdd_bres(ja, jb, jt, transpose_a=ta, transpose_b=tb, pack=2)
    got = bsr_sdd.sdd_bres(a, b, t, transpose_a=ta, transpose_b=tb, pack=2)
    full = testing.dense_oracle_matmul(np.asarray(ja, np.float32), np.asarray(jb, np.float32), transpose_a=ta,
                                       transpose_b=tb)
    blocks = full.reshape(3, BS, 4, BS).transpose(0, 2, 1, 3)[t.host_row_indices(), t.host_indices]
    assert got.data.dtype == DTYPES[dtype_name][1]
    _check(got.data, want.data, dtype_name, blocks)


def test_empty_rows_and_groups_store_zeros():
    """Block-rows with no block (and an empty plan group) flush zeros in
    every schedule, as JAX's do."""
    rng = np.random.default_rng(8)
    offsets = np.array([0, 2, 2, 2, 3, 3], np.int32)
    indices = np.array([2, 0, 1], np.int32)
    data = rng.standard_normal((3, BS, BS)).astype(np.float32)
    ja = JBlockSparseMatrix.create(jnp.asarray(data), jnp.asarray(offsets), jnp.asarray(indices), (640, 384))
    a = BlockSparseMatrix.create(torch.from_numpy(data), offsets, indices, (640, 384))
    jb, b = _dense(rng, (384, 256), "float32")
    for fn, jfn in ((bsr_qstream.dsd_q, jqstream.dsd_q), (bsr_cres.dsd_cres, jcres.dsd_cres),
                    (lambda *x: bsr_cres.dsd_gres(*x, group_rows=2), lambda *x: jcres.dsd_gres(*x, group_rows=2))):
        got = fn(a, b)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(ja, jb)), atol=1e-4, rtol=1e-5)
        assert not got.reshape(5, BS, -1)[[1, 2, 4]].any()


def test_empty_matrix_and_bad_options():
    """No nonzero block: zeros (SDD: the topology), without a plan; a
    contraction mismatch and an unknown ``accum`` raise."""
    data = np.zeros((0, BS, BS), np.float32)
    a = BlockSparseMatrix.create(torch.from_numpy(data), np.zeros(3, np.int32), np.zeros(0, np.int32), (256, 384))
    b = torch.ones((384, 128))
    for fn in (bsr_qstream.dsd_q, bsr_cres.dsd_cres, bsr_cres.dsd_gres):
        out = fn(a, b)
        assert tuple(out.shape) == (256, 128) and not out.any()
    assert bsr_sdd.sdd_bres(torch.ones(256, 128), torch.ones(128, 384), a) is a
    with pytest.raises(ValueError, match="contraction"):
        bsr_cres.dds_cres(torch.ones(128, 200), a)
    with pytest.raises(ValueError, match="accum"):
        bsr_qstream.dsd_q(a, b, accum="fast")
