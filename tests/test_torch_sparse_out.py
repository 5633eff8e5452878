"""The port's SSD / SDS / DSS / SSS, their planners and metadata helpers
against the JAX package, on the CPU.

The same numpy inputs go through both packages. JAX runs as its own tests
run it (Pallas in interpret mode, first-fit dispatch); the port runs each
CPU route: the four kernels' plain versions (``cuda_flat``,
``cuda_output_stationary``, ``cuda_worklist``, ``cuda_masked_stream``,
which on CPU tensors compute their kernel's arithmetic from the same plan,
work list or position map), the dense detours and ``torch_reference``.
Plans and metadata must equal JAX's exactly. Tolerances: fp32 atol 1e-4 and
rtol 1e-5 (the same fp32 products summed in another order, up to K = 384
terms); bf16 the reference's ATOL with inputs scaled so that outputs are of
order one (two bf16 roundings of the same fp32 sums).

The CUDA kernels are held against their plain versions on the card in
tests/test_torch_gpu.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import formats as jformats
from sputnik_tpu import ops as jops
from sputnik_tpu.kernels import bsr_dss as jbsr_dss
from sputnik_tpu.kernels import bsr_flat as jbsr_flat
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import formats, ops
from sputnik_tpu_torch.kernels import bsr_dss, bsr_flat, bsr_ssd
from sputnik_tpu_torch.ops.matmul import _PLANS
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.testing import ATOL

BS = 128
MODES = [(False, False), (False, True), (True, False), (True, True)]
M, K, N = 512, 384, 256
JAX_TOL = dict(atol=1e-4, rtol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ROUTES = {
    "ssd": ("cuda_flat", "dense_extract", "cuda_output_stationary", "torch_reference"),
    "sds": ("cuda_flat", "dense_extract", "cuda_output_stationary", "torch_reference"),
    "dss": ("cuda_flat", "densify", "cuda_worklist", "cuda_masked_stream", "torch_reference"),
    "sss": ("cuda_flat", "dss_extract", "torch_reference"),
}


def _pair(seed, rows, cols, density, *, dtype="float32", scale=1.0, pad_rows_to=1):
    """The same random BSR in both packages: unordered indices, padding
    blocks (zeros at a duplicate (row, col)) with ``pad_rows_to``."""
    nnz = max(int(rows * cols * density), BS * BS)
    kw = dict(unordered=True, pad_rows_to=pad_rows_to)
    jm = jtesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, **kw)
    tm = testing.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, device="cpu", **kw)
    data = np.asarray(jm.data) * np.float32(scale)
    jdt, tdt = DTYPES[dtype]
    return jm.with_data(jnp.asarray(data, jdt)), tm.with_data(torch.from_numpy(data).to(tdt))


def _dense(rng, shape, *, dtype="float32", scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _stored(shape, transposed):
    return shape[::-1] if transposed else shape


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _assert_schedules_equal(ts: bsr_flat.FlatSchedule, js):
    for f in ("out_ids", "dep_ids", "data_ids", "other_ids", "flags", "unvisited_ids", "slab_ids"):
        np.testing.assert_array_equal(getattr(ts, f), np.asarray(getattr(js, f)), err_msg=f)
    for f in ("kind", "total", "group", "n_steps", "all_visited", "slab"):
        assert getattr(ts, f) == getattr(js, f), f


# ------------------------------------------------------------- planners --
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("transposed", [False, True])
def test_sparse_out_plans_match_jax(transposed, group):
    ja, ta = _pair(1, *_stored((M, K), transposed), 0.3, pad_rows_to=2)
    jb, tb = _pair(2, *_stored((K, N), transposed), 0.3, pad_rows_to=2)
    jt, tt = _pair(3, M, N, 0.4)
    _assert_schedules_equal(
        bsr_flat.plan_sparse_out(ta, tt, kind="ssd", stream_transposed=transposed, group=group),
        jbsr_flat.plan_sparse_out(ja, jt, kind="ssd", stream_transposed=transposed, group=group))
    _assert_schedules_equal(
        bsr_flat.plan_sparse_out(tb, tt, kind="sds", stream_transposed=not transposed, group=group),
        jbsr_flat.plan_sparse_out(jb, jt, kind="sds", stream_transposed=not transposed, group=group))
    _assert_schedules_equal(ops.plan_ssd(ta, tt, transpose_a=transposed), jops.plan_ssd(ja, jt, transpose_a=transposed))
    _assert_schedules_equal(ops.plan_sds(tb, tt, transpose_b=transposed), jops.plan_sds(jb, jt, transpose_b=transposed))


@pytest.mark.parametrize("group", [1, 4])
def test_slab_plans_match_jax(group):
    ja, ta = _pair(4, M, K, 0.5)
    jb, tb = _pair(5, N, K, 0.5)
    jt, tt = _pair(6, M, N, 0.4)
    _assert_schedules_equal(
        bsr_flat.plan_sparse_out(ta, tt, kind="ssd", stream_transposed=False, group=group, slab=True),
        jbsr_flat.plan_sparse_out(ja, jt, kind="ssd", stream_transposed=False, group=group, slab=True))
    _assert_schedules_equal(
        bsr_flat.plan_sparse_out(tb, tt, kind="sds", stream_transposed=False, group=group, slab=True),
        jbsr_flat.plan_sparse_out(jb, jt, kind="sds", stream_transposed=False, group=group, slab=True))
    with pytest.raises(ValueError, match="natural-order"):
        bsr_flat.plan_sparse_out(tb, tt, kind="sds", stream_transposed=True, slab=True)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("ta,tb", MODES)
def test_dss_sss_plans_match_jax(ta, tb, group):
    ja, a = _pair(7, *_stored((M, K), ta), 0.4, pad_rows_to=2)
    jb, b = _pair(8, *_stored((K, N), tb), 0.4, pad_rows_to=2)
    jt, t = _pair(9, M, N, 0.3)
    kw = dict(transpose_a=ta, transpose_b=tb, group=group)
    _assert_schedules_equal(bsr_flat.plan_dss(a, b, **kw), jbsr_flat.plan_dss(ja, jb, **kw))
    _assert_schedules_equal(bsr_flat.plan_sss(a, b, t, **kw), jbsr_flat.plan_sss(ja, jb, jt, **kw))


def test_empty_plans_match_jax():
    """Disjoint patterns: an empty intersection, n_steps == 0."""
    blocks = np.ones((3, BS, BS), np.float32)
    ja = jtesting.bsr_from_blocks(384, 384, [0, 1, 2], [0, 0, 0], blocks)
    jb = jtesting.bsr_from_blocks(384, 384, [2, 2, 2], [0, 1, 2], blocks)
    a = testing.bsr_from_blocks(384, 384, [0, 1, 2], [0, 0, 0], blocks, device="cpu")
    b = testing.bsr_from_blocks(384, 384, [2, 2, 2], [0, 1, 2], blocks, device="cpu")
    ts, js = bsr_flat.plan_dss(a, b), jbsr_flat.plan_dss(ja, jb)
    _assert_schedules_equal(ts, js)
    assert ts.n_steps == 0
    _assert_schedules_equal(bsr_flat.plan_sss(a, b, a), jbsr_flat.plan_sss(ja, jb, ja))


# ------------------------------------------------------- metadata helpers --
def test_position_map_bitmask_transpose_match_jax():
    ja, ta = _pair(10, M, K, 0.4, pad_rows_to=3)  # padding blocks at duplicate (row, col)
    args = (ta.offsets, ta.indices, ta.block_rows, ta.block_cols)
    jargs = (ja.offsets, ja.indices, ja.block_rows, ja.block_cols)
    np.testing.assert_array_equal(formats.block_position_map(*args).numpy(),
                                  np.asarray(jformats.block_position_map(*jargs)))
    np.testing.assert_array_equal(ta.position_map().numpy(), np.asarray(ja.position_map()))
    np.testing.assert_array_equal(formats.block_bitmask(*args).numpy(), np.asarray(jformats.block_bitmask(*jargs)))
    tt, jt = ta.transpose(), ja.transpose()
    for f in ("data", "offsets", "indices", "row_indices"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    assert tt.shape == jt.shape
    assert (tt.max_row_nnz, tt.max_col_nnz, tt.min_row_nnz, tt.min_col_nnz) == (
        jt.max_row_nnz, jt.max_col_nnz, jt.min_row_nnz, jt.min_col_nnz)
    # The transpose keeps host copies equal to its own metadata.
    np.testing.assert_array_equal(tt.host_offsets, tt.offsets.numpy())
    np.testing.assert_array_equal(tt.host_indices, tt.indices.numpy())
    assert ta.astype(torch.bfloat16).dtype == torch.bfloat16 and ta.astype(torch.bfloat16).host_known


@pytest.mark.parametrize("ta,tb", MODES)
def test_worklist_matches_jax(ta, tb):
    """worklist_budget and the eagerly built, trimmed work list equal JAX's."""
    ja, a = _pair(11, *_stored((M, K), ta), 0.3)
    jb, b = _pair(12, *_stored((K, N), tb), 0.3)
    kw = dict(transpose_a=ta, transpose_b=tb)
    assert bsr_dss.worklist_budget(a, b, **kw) == jbsr_dss.worklist_budget(ja, jb, **kw)
    twl, jwl = bsr_dss.build_dss_worklist(a, b, **kw), jbsr_dss.build_dss_worklist(ja, jb, **kw)
    for name, x, y in zip(("out_sorted", "a_ids", "b_ids", "flags", "visited"), twl, jwl):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    assert twl.signature == jwl.signature


def test_worklist_untrimmed_without_host_copy():
    """Without a host copy the list keeps the static budget, as JAX keeps it
    under jit; dead slots repeat the last real item with flag 0."""
    ja, a = _pair(13, M, K, 0.3)
    jb, b = _pair(14, K, N, 0.3)
    budget = bsr_dss.worklist_budget(a, b)
    no_host = dataclasses.replace(a, host_offsets=None, host_indices=None)
    wl = bsr_dss.build_dss_worklist(no_host, b)
    trimmed = bsr_dss.build_dss_worklist(a, b)
    n = int(trimmed.flags.sum())
    assert wl.out_sorted.numel() == budget > n == trimmed.out_sorted.numel()
    assert int(wl.flags.sum()) == n and not wl.flags[n:].any()
    for x, y in zip((wl.out_sorted, wl.a_ids, wl.b_ids), (trimmed.out_sorted, trimmed.a_ids, trimmed.b_ids)):
        np.testing.assert_array_equal(x[:n].numpy(), y.numpy())
        assert bool((x[n:] == y[-1]).all())
    np.testing.assert_array_equal(wl.visited.numpy(), trimmed.visited.numpy())
    out = bsr_dss.dss_worklist(no_host, b, worklist=wl)
    np.testing.assert_allclose(out.numpy(), np.asarray(jops.matmul_dss(ja, jb)), **JAX_TOL)


def test_worklist_signature_guard():
    _, a = _pair(15, 512, 512, 0.2)
    _, b = _pair(16, 512, 512, 0.2)
    wl = bsr_dss.build_dss_worklist(a, b)
    bsr_dss.dss_worklist(a, b, worklist=wl)
    with pytest.raises(ValueError, match="different problem"):
        bsr_dss.dss_worklist(a, b, transpose_a=True, transpose_b=True, worklist=wl)
    _, c = _pair(17, 256, 512, 0.2)
    with pytest.raises(ValueError, match="contraction mismatch"):
        bsr_dss.build_dss_worklist(a, c)


# ---------------------------------------------------------------- the ops --
def _problem(op, ta, tb, dtype, rng):
    """(jax args, torch args) of ``op`` at (M, K, N), inputs scaled so that
    every output is of order one. A sparse A carries padding blocks; a
    sparse B none: the position map keeps one block of a duplicated (k, n),
    so the position-map routes of both packages (the masked DSS stream and
    the SSS plan) read B's padding as its only block there."""
    sa, sb = _stored((M, K), ta), _stored((K, N), tb)
    scale = dict(scale=K ** -0.25, dtype=dtype)
    sparse_a = op in ("ssd", "dss", "sss")
    sparse_b = op in ("sds", "dss", "sss")
    ja, a = _pair(20, *sa, 0.3, pad_rows_to=2, **scale) if sparse_a else _dense(rng, sa, **scale)
    jb, b = _pair(21, *sb, 0.3, **scale) if sparse_b else _dense(rng, sb, **scale)
    if op == "dss":
        return (ja, jb), (a, b)
    jt, t = _pair(22, M, N, 0.3, dtype=dtype)
    return (ja, jb, jt), (a, b, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ta,tb", MODES)
@pytest.mark.parametrize("op", ["ssd", "sds", "dss", "sss"])
def test_ops_match_jax_on_every_cpu_route(rng, op, ta, tb, dtype):
    jargs, targs = _problem(op, ta, tb, dtype, rng)
    kw = dict(transpose_a=ta, transpose_b=tb)
    expected = getattr(jops, f"matmul_{op}")(*jargs, **kw)
    expected = _np(expected if op == "dss" else expected.data)
    tol = JAX_TOL if dtype == "float32" else dict(atol=ATOL, rtol=0)
    for route in ROUTES[op]:
        out = getattr(ops, f"matmul_{op}")(*targs, variant=route, **kw)
        got = out if op == "dss" else out.data
        assert got.dtype == DTYPES[dtype][1], route
        np.testing.assert_allclose(_np(got), expected, err_msg=route, **tol)
    # The differentiable entry point without options takes first fit.
    out = getattr(ops, op)(*targs, **kw)
    np.testing.assert_allclose(_np(out if op == "dss" else out.data), expected, **tol)


# The JAX package's first-fit names and the port's for the same route.
JAX_ROUTE = {"pallas_flat_schedule": "cuda_flat", "pallas_dsd_extract": "dense_extract",
             "pallas_dds_extract": "dense_extract", "pallas_densify_stream": "densify",
             "pallas_output_stationary": "cuda_output_stationary", "dss_extract": "dss_extract"}


@pytest.mark.parametrize("density", [0.05, 0.3, 0.6])
@pytest.mark.parametrize("op", ["ssd", "sds", "dss", "sss"])
def test_first_fit_routes_like_jax(rng, op, density):
    """Host-known metadata routes as concrete metadata does in the JAX
    package, at the JAX package's thresholds."""
    sa, sb = (M, K), (K, N)
    ja, a = _pair(30, *sa, density) if op != "sds" else _dense(rng, sa)
    jb, b = _pair(31, *sb, density) if op in ("sds", "dss", "sss") else _dense(rng, sb)
    jt, t = _pair(32, M, N, density)
    jargs, targs = ((ja, jb), (a, b)) if op == "dss" else ((ja, jb, jt), (a, b, t))
    jname = jops.registry.dispatch_name(op, *jargs)
    assert registry.dispatch_name(op, *targs) == JAX_ROUTE[jname], jname


def test_plans_are_cached_per_topology_pair(rng):
    _, a = _pair(33, M, K, 0.1)
    _, t = _pair(34, M, N, 0.05)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    assert registry.dispatch_name("ssd", a, b, t) == "cuda_flat"
    assert registry.dispatch_name("ssd", a, b, t, schedule=ops.plan_ssd(a, t)) == "cuda_flat"
    first = ops.matmul_ssd(a, b, t)
    again = ops.matmul_ssd(a.with_data(a.data * 2), b, t.with_transpose_metadata())
    torch.testing.assert_close(again.data, 2 * first.data)
    assert (("ssd", False), (id(a.indices), id(t.indices))) in _PLANS
    # Metadata without a host copy (built on a card) never takes cuda_flat.
    no_host = dataclasses.replace(a, host_offsets=None, host_indices=None)
    assert registry.dispatch_name("ssd", no_host, b, t) == "dense_extract"


def test_generic_matmul_dispatch(rng):
    (ja, jb, jt), (a, b, t) = _problem("sss", False, False, "float32", rng)
    _, dense = _dense(rng, (K, N))
    for args, kw, op in (((a, b), {}, "dss"), ((a, dense), {}, "dsd"), ((a, dense), {"topology": t}, "ssd"),
                         ((a, b), {"topology": t}, "sss")):
        got = ops.matmul(*args, **kw)
        want = getattr(ops, f"matmul_{op}")(*args, *kw.values())
        torch.testing.assert_close(got if op in ("dss", "dsd") else got.data,
                                   want if op in ("dss", "dsd") else want.data)
    x, y = torch.randn(M, K), torch.randn(K, N)
    torch.testing.assert_close(ops.matmul(x, y), x @ y)
    np.testing.assert_allclose(ops.matmul(a, b, topology=t).data.numpy(),
                               np.asarray(jops.matmul(ja, jb, topology=jt).data), **JAX_TOL)


def test_sss_shape_errors(rng):
    _, a = _pair(24, 640, 384, 0.3)
    _, b = _pair(25, 384, 512, 0.3)
    _, bad = _pair(26, 640, 384, 0.3)
    with pytest.raises(ValueError, match="topology"):
        ops.matmul_sss(a, b, bad)
    _, bad_b = _pair(27, 512, 512, 0.3)
    with pytest.raises(ValueError, match="contraction"):
        ops.matmul_sss(a, bad_b, bad)
    # Mixed block sizes fall through to dss_extract, as in the JAX package.
    _, a = _pair(28, 512, 384, 0.05)
    topo256 = testing.random_bsr(rng, 512, 512, 512 * 512 // 8, 256, device="cpu")
    assert registry.dispatch_name("sss", a, b, topo256) == "dss_extract"


def test_empty_work_is_zero():
    """Empty output rows, an empty intersection and an empty schedule."""
    blocks = np.ones((3, BS, BS), np.float32)
    a = testing.bsr_from_blocks(384, 384, [0, 1, 2], [0, 0, 0], blocks, device="cpu")
    b = testing.bsr_from_blocks(384, 384, [2, 2, 2], [0, 1, 2], blocks, device="cpu")
    for route in ROUTES["dss"]:
        out = ops.matmul_dss(a, b, variant=route)
        assert out.shape == (384, 384) and not out.any(), route
    for route in ROUTES["sss"]:
        assert not ops.matmul_sss(a, b, a, variant=route).data.any(), route
    dense = torch.ones(384, 384)
    empty_rows = testing.bsr_from_blocks(384, 384, [0], [1], blocks[:1], device="cpu")
    topo = testing.bsr_from_blocks(384, 384, [0, 2], [0, 2], blocks[:2], device="cpu")
    for route in ROUTES["ssd"]:
        out = ops.matmul_ssd(empty_rows, dense, topo, variant=route).data
        assert bool((out[0] == 128).all()) and not out[1].any(), route


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take(rng):
    _, a = _pair(29, 256, 256, 0.5)
    x = torch.zeros(256, 256)
    with pytest.raises(ValueError, match="CUDA"):
        bsr_flat.check_operands("bsr_flat", [("a", a.data)], torch.empty(1, device="meta"))
    with pytest.raises(ValueError, match="kcat"):
        bsr_flat.ssd_flat(a, x, a, kcat=1)
    with pytest.raises(ValueError, match="topology"):
        bsr_ssd.ssd(a, torch.zeros(256, 128), a)
    with pytest.raises(ValueError, match="schedule kind"):
        bsr_flat.sds_flat(x, a, a, schedule=ops.plan_ssd(a, a))
    assert bsr_flat.LAUNCHES == 0 and bsr_ssd.LAUNCHES == 0 and not any(bsr_dss.LAUNCHES.values())
