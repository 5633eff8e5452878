"""The port's panel-resident and column-stacked DSD / DDS schedules
(``kernels/bsr_panel.py``, ``kernels/bsr_cstack.py``), the gather-and-bmm
variant (``kernels/xla_gather.py``) and DDS's ``cuda_stream_at`` against
the JAX package's, on the CPU.

The same numpy inputs go through both packages; JAX runs its Pallas kernels
in interpret mode (``tests/conftest.py``), as ``tests/test_bsr_matmul.py``
runs them, the port its kernels' plain versions on the same plans (a CPU
tensor takes them). Plans agree exactly: the panel stream with its group
adaptation, the cstack q-slot plan built on the host (JAX: concrete) and on
the metadata's device (JAX: traced under ``jax.jit``), the VMEM gates and
tiles. fp32 values at atol 1e-4 / rtol 1e-5, bf16 at the reference ATOL
(inputs scaled by 1/4, so that one bf16 ulp of an output stays below it),
and both against the fp64 oracle. The registry predicates of the seven new
variants agree with JAX's on both kinds of metadata. The CUDA kernels are
held against the plain versions on the card in tests/test_torch_gpu.py.
"""

import dataclasses
import importlib
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import formats as jformats
from sputnik_tpu import ops as jops
from sputnik_tpu.kernels import bsr_cres as jcres
from sputnik_tpu.kernels import bsr_cstack as jcstack
from sputnik_tpu.kernels import bsr_panel as jpanel
from sputnik_tpu.kernels import bsr_qstream as jqstream
from sputnik_tpu.kernels import xla_gather as jgather
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import ops
from sputnik_tpu_torch.formats import BlockSparseMatrix, bsr_from_dense
from sputnik_tpu_torch.kernels import bsr_cstack, bsr_panel, xla_gather
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.testing import ATOL

matmul_mod = importlib.import_module("sputnik_tpu_torch.ops.matmul")

BS = 128
MODES = [(False, False), (False, True), (True, False), (True, True)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype_name):
    return dict(atol=1e-4, rtol=1e-5) if dtype_name == "float32" else dict(atol=ATOL, rtol=0)


def _scale(dtype_name):
    return 1.0 if dtype_name == "float32" else 0.25


def _with(jm, tm, dtype_name, seed):
    """Both matrices with the same values, scaled for the dtype."""
    jdt, tdt = DTYPES[dtype_name]
    data = np.random.default_rng(seed + 100).standard_normal(tuple(jm.data.shape)).astype(np.float32)
    data *= _scale(dtype_name)
    return jm.with_data(jnp.asarray(data, jdt)), tm.with_data(torch.from_numpy(data).to(tdt))


def _pair(seed, rows, cols, density, dtype_name="float32", **kw):
    """The same random BSR in both packages."""
    nnz = max(int(rows * cols * density), BS * BS)
    jm = jtesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, **kw)
    tm = testing.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, device="cpu", **kw)
    return _with(jm, tm, dtype_name, seed)


def _blocks_pair(rows, cols, coords, dtype_name="float32", seed=9):
    """A hand-built BSR in both packages from (block-row, block-column) pairs."""
    counts = np.bincount([r for r, _ in coords], minlength=rows // BS)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    cols_ = np.asarray([c for _, c in coords], np.int32)
    zeros = np.zeros((len(coords), BS, BS), np.float32)
    jm = jformats.BlockSparseMatrix.create(jnp.asarray(zeros), jnp.asarray(offsets), jnp.asarray(cols_), (rows, cols))
    tm = BlockSparseMatrix.create(torch.from_numpy(zeros), offsets, cols_, (rows, cols))
    return _with(jm, tm, dtype_name, seed)


def _dense(rng, shape, dtype_name="float32"):
    jdt, tdt = DTYPES[dtype_name]
    x = rng.standard_normal(shape).astype(np.float32) * _scale(dtype_name)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _check(got, want, dtype_name, oracle):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype_name))
    np.testing.assert_allclose(got.float().numpy(), oracle, **_tol(dtype_name))


def _card_built(m):
    return dataclasses.replace(m, host_offsets=None, host_indices=None)


def _dims(m, k, n, ta, tb):
    return ((k, m) if ta else (m, k)), ((n, k) if tb else (k, n))


# ------------------------------------------------------------------ plans --
# Ragged rows (25%, unordered), an empty block-row and block-column, and
# rows of ~3 blocks, so that the adaptive group takes 1, 2 and 4.
PLAN_TOPOLOGIES = {
    "ragged": lambda: _pair(1, 768, 640, 0.3, unordered=True),
    "empty_rows": lambda: _blocks_pair(512, 512, [(0, 0), (0, 2), (2, 0), (3, 3)]),
    "dense_rows": lambda: _pair(2, 512, 1024, 0.9),
    "sparse": lambda: _pair(3, 1024, 1024, 0.05, unordered=True),
}


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("topology", sorted(PLAN_TOPOLOGIES))
def test_plan_stream_matches_jax(topology, transposed):
    """The panel stream (DSD: ``transposed=transpose_a``; DDS:
    ``transposed=not transpose_b``), field by field, and its group."""
    jm, tm = PLAN_TOPOLOGIES[topology]()
    for group in (4, 2):
        want = jpanel.plan_stream(jm, transposed=transposed, group=group)
        got = bsr_panel.plan_stream(tm, transposed=transposed, group=group)
        for f in ("out_ids", "dep_ids", "data_ids", "other_ids", "flags", "unvisited_ids"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
        assert (got.total, got.group, got.n_steps, got.kind) == (want.total, want.group, want.n_steps, "stream")


def test_panel_and_cstack_gates_match_jax():
    """``panel_fits``, ``_pick_panel_tile``, ``cstack_fits`` and the cstack
    tile's halving, on both sides of every budget."""
    for k_dim in (128, 384, 2048, 4096, 8192, 16384, 32768):
        for isz in (2, 4):
            assert bsr_panel.panel_fits(k_dim, isz) == jpanel.panel_fits(k_dim, isz)
            for n_dim in (128, 384, 512, 2048, 4096, 16384):
                for staged in (False, True):
                    assert bsr_panel._pick_panel_tile(n_dim, k_dim, isz, BS, staged) == \
                        jpanel._pick_panel_tile(n_dim, k_dim, isz, BS, staged)
    for m_dim in (640, 2048, 4096, 16384, 65536, 196608, 262144):
        for n_tile in (128, 256, 1024, 2048, 4096, 8192):
            assert bsr_cstack.cstack_fits(m_dim, n_tile) == jcstack.cstack_fits(m_dim, n_tile)
            for n_dim in (512, 4096, 16384):
                nt = min(n_tile, n_dim)  # JAX's dsd_cstack, inline there
                while nt > 128 and not jcstack.cstack_fits(m_dim, nt):
                    nt = max(128, (nt // 2) // 128 * 128)
                assert bsr_cstack.cstack_tile(m_dim, n_dim, n_tile) == nt


def _jax_cstack_plan(jm, q, *, concrete):
    """JAX's cstack plan: ``_dep_major_arrays`` + ``_plan`` (traced under
    ``jax.jit`` when not ``concrete``), and its ``frows``."""
    counts = np.diff(np.asarray(jm.with_transpose_metadata().offsets_t))
    ks, rows, datas = (np.asarray(x) for x in jcres._dep_major_arrays(jm, op_transposed=False))
    if concrete:
        out = jqstream._plan(ks, rows, datas, counts, q, concrete=True)
    else:
        box = {}

        def traced(*arrays):
            res = jqstream._plan(*arrays, q, concrete=False)
            box["n_steps"] = res[4]
            return res[:4]

        out = (*jax.jit(traced)(jnp.asarray(ks), jnp.asarray(rows), jnp.asarray(datas), jnp.asarray(counts)),
               box["n_steps"])
    m_blocks = jm.rows // BS
    frows = jnp.concatenate([jnp.zeros((out[4],), jnp.int32), jnp.arange(m_blocks, dtype=jnp.int32)])
    return [np.asarray(x) for x in out[:4]] + [out[4], np.asarray(frows)]


@pytest.mark.parametrize("built", ["host", "device"])
@pytest.mark.parametrize("q", [4, 8])
def test_cstack_plan_matches_jax(q, built):
    """(k_q, row_q, data_q, nv, n_steps, frows): on host-known metadata
    against JAX's concrete plan, on metadata without a host copy (the plan
    built where the metadata lives, CPU tensors here) against JAX's traced
    plan."""
    for jm, tm in (_pair(4, 640, 1024, 0.3, unordered=True), _blocks_pair(512, 512, [(0, 0), (0, 2), (2, 0), (3, 3)])):
        if built == "device":
            tm = _card_built(tm)
        want = _jax_cstack_plan(jm, q, concrete=built == "host")
        plan = bsr_cstack.cstack_plan(tm, q)
        assert isinstance(plan.out_q, torch.Tensor) == (built == "device")
        got = [np.asarray(torch.as_tensor(x)) for x in (plan.out_q, plan.dep_q, plan.data_q, plan.nv)]
        # The kernel's flush: every output block-row once, in order, after
        # the plan's steps (JAX's frows, 0 during the MACs).
        frows = np.concatenate([np.zeros(plan.n_steps, np.int32), np.arange(tm.rows // BS, dtype=np.int32)])
        got += [plan.n_steps, frows]
        for name, x, y in zip(("k_q", "row_q", "data_q", "nv", "n_steps", "frows"), want, got):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=name)


# ----------------------------------------------------------------- values --
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_panel_matches_jax(rng, dtype_name, ta, tb):
    """dsd_panel and dds_panel in every mode at JAX's test shape, through
    ``variant=`` in both registries."""
    m, k, n = 512, 384, 256
    a_shape, b_shape = _dims(m, k, n, ta, tb)
    ja, a = _pair(5, *a_shape, 0.25, dtype_name, unordered=True)
    jb, b = _dense(rng, b_shape, dtype_name)
    oracle = testing.dense_oracle_matmul(np.asarray(ja.to_dense(), np.float32), np.asarray(jb, np.float32),
                                         transpose_a=ta, transpose_b=tb)
    kw = dict(transpose_a=ta, transpose_b=tb)
    got = ops.matmul_dsd(a, b, variant="cuda_panel", **kw)
    assert got.dtype == DTYPES[dtype_name][1] and tuple(got.shape) == (m, n)
    _check(got, jops.matmul_dsd(ja, jb, variant="pallas_panel", **kw), dtype_name, oracle)
    jd, d = _dense(rng, a_shape, dtype_name)
    jsp, sp = _pair(6, *b_shape, 0.25, dtype_name, unordered=True)
    oracle = testing.dense_oracle_matmul(np.asarray(jd, np.float32), np.asarray(jsp.to_dense(), np.float32),
                                         transpose_a=ta, transpose_b=tb)
    _check(ops.matmul_dds(d, sp, variant="cuda_panel", **kw), jops.matmul_dds(jd, jsp, variant="pallas_panel", **kw),
           dtype_name, oracle)


def test_panel_empty_groups(rng):
    """JAX's ``test_panel_empty_groups``: an empty block-row and
    block-column come out zero, in DSD and DDS, with a given schedule too."""
    jsp, sp = _blocks_pair(512, 512, [(0, 0), (0, 2), (2, 0), (3, 3)])
    jb, b = _dense(rng, (512, 256))
    got = bsr_panel.dsd_panel(sp, b, schedule=bsr_panel.plan_stream(sp, transposed=False))
    _check(got, jpanel.dsd_panel(jsp, jb), "float32", testing.dense_oracle_matmul(np.asarray(jsp.to_dense()), jb))
    assert not got[128:256].any()
    jd, d = _dense(rng, (256, 512))
    got = bsr_panel.dds_panel(d, sp)
    _check(got, jpanel.dds_panel(jd, jsp), "float32", testing.dense_oracle_matmul(jd, np.asarray(jsp.to_dense())))
    assert not got[:, 128:256].any()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("tb", [False, True])
def test_cstack_matches_jax(rng, tb, dtype_name):
    """dsd_cstack at q 4 and 8, n_tile 256, at JAX's test shape, on
    host-known and card-built metadata (both planned here, on the CPU)."""
    m, k, n = 640, 384, 512
    a_shape, b_shape = _dims(m, k, n, False, tb)
    ja, a = _pair(7, *a_shape, 0.3, dtype_name, unordered=True)
    jb, b = _dense(rng, b_shape, dtype_name)
    oracle = testing.dense_oracle_matmul(np.asarray(ja.to_dense(), np.float32), np.asarray(jb, np.float32),
                                         transpose_b=tb)
    for q in (4, 8):
        want = jops.matmul_dsd(ja, jb, transpose_b=tb, variant="pallas_cstack", q=q, n_tile=256)
        _check(ops.matmul_dsd(a, b, transpose_b=tb, variant="cuda_cstack", q=q, n_tile=256), want, dtype_name, oracle)
        _check(bsr_cstack.dsd_cstack(_card_built(a), b, transpose_b=tb, q=q, n_tile=256), want, dtype_name, oracle)


def test_cstack_raises_as_jax(rng):
    """transpose_a and an accumulator past the budget raise JAX's errors."""
    ja, a = _pair(8, 640, 384, 0.3)
    _, b = _dense(rng, (384, 256))
    with pytest.raises(ValueError, match="transpose_a=False only"):
        ops.matmul_dsd(a, torch.ones((256, 640)), transpose_a=True, transpose_b=True, variant="cuda_cstack")
    with mock.patch.object(bsr_cstack, "cstack_fits", lambda m_, nt: False):
        with pytest.raises(ValueError, match="VMEM budget"):
            bsr_cstack.dsd_cstack(a, b)
    with pytest.raises(ValueError, match="multiple of 128"):
        bsr_cstack.dsd_cstack(a, b, n_tile=200)


@pytest.mark.parametrize("tb", [False, True])
@pytest.mark.parametrize("case", ["uniform", "uniform_unordered", "ragged"])
def test_dsd_gather_bmm_matches_jax(rng, case, tb):
    """JAX's gather tests: uniform rows (ordered and not) at 512 x 768 x 384,
    ragged rows (a padded slot map) at 640 x 512 x 384."""
    m, k, n = (640, 512, 384) if case == "ragged" else (512, 768, 384)
    a_shape, b_shape = _dims(m, k, n, False, tb)
    kw = {} if case == "ragged" else dict(perfect_uniform=True, unordered=case == "uniform_unordered")
    ja, a = _pair(10, *a_shape, 0.3 if case == "ragged" else 0.4, **kw)
    assert (xla_gather.uniform_row_width(a) is None) == (case == "ragged")
    assert xla_gather.uniform_row_width(a) == jgather.uniform_row_width(ja)
    jb, b = _dense(rng, b_shape)
    oracle = testing.dense_oracle_matmul(np.asarray(ja.to_dense()), np.asarray(jb), transpose_b=tb)
    _check(ops.matmul_dsd(a, b, transpose_b=tb, variant="xla_gather_bmm"),
           jops.matmul_dsd(ja, jb, transpose_b=tb, variant="xla_gather_bmm"), "float32", oracle)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ta", [False, True])
def test_dds_gather_bmm_matches_jax(rng, ta, dtype_name):
    """Uniform block-columns of B (JAX's: the transpose of a perfect-uniform
    pattern)."""
    m, k, n = 384, 640, 512
    a_shape, _ = _dims(m, k, n, ta, False)
    jbt, _ = _pair(11, n, k, 0.4, perfect_uniform=True)
    dense_b = np.asarray(jbt.to_dense()).T * _scale(dtype_name)
    jb = jformats.bsr_from_dense(jnp.asarray(dense_b, DTYPES[dtype_name][0]), BS)
    b = bsr_from_dense(torch.from_numpy(np.ascontiguousarray(dense_b)).to(DTYPES[dtype_name][1]), BS, device="cpu")
    assert xla_gather.uniform_col_width(b) == jgather.uniform_col_width(jb) is not None
    ja, a = _dense(rng, a_shape, dtype_name)
    oracle = testing.dense_oracle_matmul(np.asarray(ja, np.float32), np.asarray(jb.to_dense(), np.float32),
                                         transpose_a=ta)
    got = ops.matmul_dds(a, b, transpose_a=ta, variant="xla_gather_bmm")
    assert got.dtype == DTYPES[dtype_name][1]
    _check(got, jops.matmul_dds(ja, jb, transpose_a=ta, variant="xla_gather_bmm"), dtype_name, oracle)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_dds_stream_at_matches_jax(rng, dtype_name, ta, tb):
    """DDS's ``cuda_stream_at`` (A restaged K-major) against JAX's
    ``pallas_stream_at`` in every mode."""
    m, k, n = 256, 384, 512
    a_shape, b_shape = _dims(m, k, n, ta, tb)
    jd, d = _dense(rng, a_shape, dtype_name)
    jsp, sp = _pair(12, *b_shape, 0.3, dtype_name, unordered=True)
    oracle = testing.dense_oracle_matmul(np.asarray(jd, np.float32), np.asarray(jsp.to_dense(), np.float32),
                                         transpose_a=ta, transpose_b=tb)
    kw = dict(transpose_a=ta, transpose_b=tb)
    _check(ops.matmul_dds(d, sp, variant="cuda_stream_at", **kw),
           jops.matmul_dds(jd, jsp, variant="pallas_stream_at", **kw), dtype_name, oracle)


# ------------------------------------------------------------------ gates --
def _jax_can(op, name, jargs, kw, traced):
    v = next(v for v in jops.registry.variants_for(op) if v.name == name)
    if not traced:
        return bool(v.can_implement(*jargs, **kw))
    out = []

    def trace(*args):
        out.append(bool(v.can_implement(*args, **kw)))
        return 0

    jax.make_jaxpr(trace)(*jargs)
    return out[0]


NEW_VARIANTS = [("dsd", "cuda_panel", "pallas_panel"), ("dsd", "cuda_cstack", "pallas_cstack"),
                ("dsd", "cuda_cstack_q4", "pallas_cstack_q4"), ("dsd", "xla_gather_bmm", "xla_gather_bmm"),
                ("dds", "cuda_panel", "pallas_panel"), ("dds", "xla_gather_bmm", "xla_gather_bmm"),
                ("dds", "cuda_stream_at", "pallas_stream_at")]


@pytest.mark.parametrize("traced", [False, True], ids=["host", "card"])
@pytest.mark.parametrize("problem", ["plain", "transposed", "uniform", "deep_fp32", "tall"])
@pytest.mark.parametrize("op,name,jname", NEW_VARIANTS)
def test_new_predicates_match_jax(monkeypatch, op, name, jname, problem, traced):
    """Each new variant takes a problem exactly when JAX's does: metadata
    known on the host (JAX: concrete) or not (JAX: traced); transposed
    sparse operands; uniform rows and columns; fp32 K past ``panel_fits``;
    M past cstack's accumulator budget. Dense operands are shape-only, so
    nothing large is allocated."""
    monkeypatch.setattr(matmul_mod, "_on_cuda", lambda *xs: True)
    rows, cols = {"deep_fp32": (512, 8192), "tall": (196608, 256)}.get(problem, (512, 768))
    jsp, sp = _pair(13, rows, cols, 0.01 if problem == "tall" else 0.4, perfect_uniform=problem == "uniform")
    if problem == "uniform" and op == "dds":
        dense_b = np.asarray(jsp.to_dense()).T
        jsp, sp = jformats.bsr_from_dense(jnp.asarray(dense_b), BS), bsr_from_dense(torch.from_numpy(
            np.ascontiguousarray(dense_b)), BS, device="cpu")
    if traced:
        sp = _card_built(sp)
    t = problem == "transposed"
    kw = {"transpose_a": t, "transpose_b": t}

    def dense(shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32), torch.empty(shape, device="meta")

    if op == "dsd":
        k_dim = sp.rows if t else sp.cols
        jb, b = dense((256, k_dim) if t else (k_dim, 256))
        jargs, targs = (jsp, jb), (sp, b)
    else:
        k_dim = sp.cols if t else sp.rows
        ja, a = dense((k_dim, 256) if t else (256, k_dim))
        jargs, targs = (ja, jsp), (a, sp)
    want = _jax_can(op, jname, jargs, kw, traced)
    got = next(v for v in registry.variants_for(op) if v.name == name).can_implement(*targs, **kw)
    assert got == want


def test_panel_predicate_takes_a_schedule(monkeypatch):
    """A given schedule lets card-built metadata take cuda_panel, as JAX's
    traced metadata with a prebuilt schedule takes pallas_panel."""
    monkeypatch.setattr(matmul_mod, "_on_cuda", lambda *xs: True)
    _, sp = _pair(14, 512, 768, 0.4)
    card = _card_built(sp)
    b = torch.empty((768, 256), device="meta")
    panel = next(v for v in registry.variants_for("dsd") if v.name == "cuda_panel")
    assert not panel.can_implement(card, b)
    assert panel.can_implement(card, b, schedule=bsr_panel.plan_stream(sp, transposed=False))
