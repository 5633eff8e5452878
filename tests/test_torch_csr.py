"""The port's CSR engine (``formats`` CSR / ELL / SELL, ``kernels/sell.py``,
``ops/csr.py``, the DLMC utilities) against the JAX package's, in fp32 on
the CPU with numpy-seeded inputs fed to both. JAX runs its SELL Pallas
kernels in interpret mode, as ``tests/test_sell.py`` does; the port runs
their plain versions, which its kernel wrappers take for CPU tensors.
Formats and metadata must match exactly; values within atol 1e-4 and
rtol 1e-5 (fp32, different summation orders)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import formats as jformats
from sputnik_tpu.kernels import sell as jsell
from sputnik_tpu.ops import csr as jcsr
from sputnik_tpu.utils import dlmc as jdlmc
from sputnik_tpu.utils import dlmc_gen as jdlmc_gen
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import formats
from sputnik_tpu_torch.kernels import sell
from sputnik_tpu_torch.ops import csr, registry
from sputnik_tpu_torch.utils import dlmc, dlmc_gen, testing

ATOL, RTOL = 1e-4, 1e-5
# tests/test_sell.py's shapes: rows / cols off 128, cols under one chunk, very sparse.
SHAPES = [(128, 128, 0.5), (256, 512, 0.1), (200, 300, 0.15), (512, 96, 0.3), (384, 384, 0.02)]
WEIGHTS = "data/dlmc_weights.npz"


def _pair(seed, rows, cols, density, **kw):
    """The same random CSR in both packages (the port's on the CPU)."""
    nnz = int(rows * cols * density)
    jm = jtesting.random_csr(np.random.default_rng(seed), rows, cols, nnz, **kw)
    tm = testing.random_csr(np.random.default_rng(seed), rows, cols, nnz, device="cpu", **kw)
    return jm, tm


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=ATOL, rtol=RTOL)


def _dense(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _same_sell(t, j):
    for name in ("values", "indices", "tile_widths", "row_perm", "slot_counts"):
        tv, jv = getattr(t, name), getattr(j, name)
        if jv is None:
            assert tv is None, name
            continue
        np.testing.assert_array_equal(_np(tv), np.asarray(jv), err_msg=name)
        if name != "values":
            assert tv.dtype == torch.int32, name
    assert (t.shape, t.chunk, t.pad_rows) == (j.shape, j.chunk, j.pad_rows)


# ------------------------------------------------------------------ formats --
@pytest.mark.parametrize("rows,cols,density", SHAPES[2:])
def test_csr_metadata_matches_jax(rows, cols, density):
    jm, tm = _pair(1, rows, cols, density, pad_rows_to=4, unordered=True)
    for name in ("values", "indices", "offsets", "row_indices"):
        np.testing.assert_array_equal(_np(getattr(tm, name)), np.asarray(getattr(jm, name)), err_msg=name)
    assert tm.shape == jm.shape and tm.nnz == jm.nnz
    np.testing.assert_array_equal(_np(tm.to_dense()), np.asarray(jm.to_dense()))
    jt, tt = jm.transpose(), tm.transpose()
    for name in ("values", "indices", "offsets", "row_indices"):
        np.testing.assert_array_equal(_np(getattr(tt, name)), np.asarray(getattr(jt, name)), err_msg=name)
    assert tt.shape == jt.shape
    mirrored = tm.with_dense_mirror()
    np.testing.assert_array_equal(_np(mirrored.dense_mirror), np.asarray(jm.with_dense_mirror().dense_mirror))
    assert mirrored.with_dense_mirror() is mirrored
    assert mirrored.with_values(tm.values * 2).dense_mirror is None
    assert mirrored.astype(torch.bfloat16).dense_mirror.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(csr.row_swizzle(tm)), np.asarray(jcsr.row_swizzle(jm)))
    width = int(np.diff(np.asarray(jm.offsets)).max())
    for got, want in zip(csr.ell_from_csr(tm, width), jcsr.ell_from_csr(jm, width)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_csr_from_dense_matches_jax(rng):
    x = rng.standard_normal((130, 70)).astype(np.float32) * (rng.random((130, 70)) < 0.2)
    x[3] = 0.0  # an empty row, padded to one zero entry
    jm = jformats.csr_from_dense(x, pad_rows_to=4)
    tm = formats.csr_from_dense(x, pad_rows_to=4, device="cpu")
    for name in ("values", "indices", "offsets", "row_indices"):
        np.testing.assert_array_equal(_np(getattr(tm, name)), np.asarray(getattr(jm, name)), err_msg=name)
    assert tm.max_row_nnz == int(np.diff(np.asarray(jm.offsets)).max())
    # A tensor keeps its device and dtype.
    tb = formats.csr_from_dense(torch.from_numpy(x).bfloat16())
    assert tb.dtype == torch.bfloat16 and tb.device.type == "cpu"
    np.testing.assert_array_equal(_np(formats.csr_to_dense(tm)), np.asarray(jformats.csr_to_dense(jm)))


@pytest.mark.parametrize("rows,cols,density", SHAPES)
@pytest.mark.parametrize("chunk", [128, 64, "auto"])
@pytest.mark.parametrize("sort_rows", [False, True])
def test_sell_from_csr_matches_jax(rows, cols, density, chunk, sort_rows):
    jm, tm = _pair(2, rows, cols, density, unordered=True)
    j = jformats.SellMatrix.from_csr(jm, chunk=chunk, sort_rows=sort_rows)
    t = formats.SellMatrix.from_csr(tm, chunk=chunk, sort_rows=sort_rows)
    _same_sell(t, j)
    np.testing.assert_array_equal(_np(t.to_dense()), _np(tm.to_dense()))
    np.testing.assert_array_equal(_np(t.valid_mask()), np.asarray(j.indices) < j.chunk)
    assert t.nnz == j.nnz and t.astype(torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="values shape"):
        t.with_values(t.values[:, :1])


@pytest.mark.parametrize("rows,cols,density", SHAPES[2:])
def test_ell_matches_jax(rows, cols, density):
    jm, tm = _pair(3, rows, cols, density, pad_rows_to=2)
    for width in (None, int(np.diff(np.asarray(jm.offsets)).max()) + 3):
        j, t = jformats.EllMatrix.from_csr(jm, width), formats.EllMatrix.from_csr(tm, width)
        for name in ("values", "indices", "row_nnz"):
            np.testing.assert_array_equal(_np(getattr(t, name)), np.asarray(getattr(j, name)), err_msg=name)
        assert t.shape == j.shape and t.indices.dtype == t.row_nnz.dtype == torch.int32
        np.testing.assert_array_equal(_np(t.valid_mask()), np.asarray(j.valid_mask()))
        np.testing.assert_array_equal(_np(t.to_dense()), np.asarray(j.to_dense()))


def test_random_csr_draws_match_jax():
    for kw in (dict(), dict(pad_rows_to=8), dict(unordered=True)):
        j = jtesting.random_csr_topology(np.random.default_rng(4), 96, 160, 1200, **kw)
        t = testing.random_csr_topology(np.random.default_rng(4), 96, 160, 1200, **kw)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- kernels --
@pytest.mark.parametrize("rows,cols,density,sort_rows",
                         [(*shape, True) for shape in SHAPES] + [(*shape, False) for shape in SHAPES[1:3]])
def test_spmm_matches_jax(rows, cols, density, sort_rows):
    jm, tm = _pair(6, rows, cols, density)
    chunk = "auto" if sort_rows else 128
    j = jformats.SellMatrix.from_csr(jm, chunk=chunk, sort_rows=sort_rows)
    t = formats.SellMatrix.from_csr(tm, chunk=chunk, sort_rows=sort_rows)
    n = 100 if rows == 200 else 64  # an odd width once
    jb, tb = _dense(np.random.default_rng(7), (cols, n))
    _close(csr.spmm(t, tb), jcsr.spmm(j, jb))
    jx, tx = _dense(np.random.default_rng(8), (rows, n))
    want = jsell.spmm_t(j, jx)
    _close(sell.spmm_t(t, tx), want)
    # The transposed SpMM is an SpMM over the transposed plan.
    _close(sell.spmm_reference(t.transpose_plan.as_sell(t.values), tx), want)


@pytest.mark.parametrize("rows,cols,density", SHAPES)
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("sort_rows", [False, True])
def test_sell_transpose_plan_matches_jax(rows, cols, density, chunk, sort_rows):
    """SellMatrix.from_csr's transposed plan is the JAX package's
    SellMatrix.from_csr(CsrMatrix.transpose()) exactly, its position map
    gathers JAX's transposed values exactly, a plan built from the SELL
    arrays alone (a shard's local matrix) is the same plan, and value
    updates keep it."""
    jm, tm = _pair(15, rows, cols, density, unordered=True)
    j = jformats.SellMatrix.from_csr(jm.transpose(), chunk=chunk, sort_rows=sort_rows)
    t = formats.SellMatrix.from_csr(tm, chunk=chunk, sort_rows=sort_rows)
    plan = t.transpose_plan
    for name in ("indices", "slot_counts", "row_perm", "tile_widths"):
        got, want = getattr(plan, name), getattr(j, name)
        if want is None:
            assert got is None, name
            continue
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=name)
        assert got.dtype == torch.int32, name
    assert (plan.shape, plan.chunk, plan.rows_padded - plan.rows) == (j.shape, j.chunk, j.pad_rows)
    assert plan.positions.dtype == torch.int32 and plan.positions.shape == plan.indices.shape
    np.testing.assert_array_equal(_np(plan.as_sell(t.values).values), np.asarray(j.values))
    bare = dataclasses.replace(t, transpose_plan=None)
    rebuilt = bare.transpose_layout()
    assert bare.transpose_layout() is rebuilt  # built once, kept on the object
    for name in ("positions", "indices", "slot_counts", "row_perm", "tile_widths"):
        got, want = getattr(rebuilt, name), getattr(plan, name)
        assert (got is None and want is None) or torch.equal(got, want), name
    assert t.with_values(t.values * 2).transpose_plan is plan
    assert t.astype(torch.bfloat16).transpose_plan is plan
    assert dataclasses.replace(t, slot_counts=None).transpose_plan is plan


@pytest.mark.parametrize("sparsity", dlmc_gen.SPARSITIES)
def test_spmm_t_plan_on_dlmc_matches_jax(sparsity):
    """The four trained DLMC-protocol matrices, built as the bench builds
    them (chunk "auto", sorted rows): the plain SpMM over the transposed
    plan and the port's spmm_t against JAX's spmm_t, n = 16."""
    jw, tw = jdlmc_gen.load_weights(WEIGHTS), dlmc_gen.load_weights(WEIGHTS)
    rng = np.random.default_rng(16)
    for key in dlmc_gen.WEIGHT_KEYS:
        jc, tc = jdlmc_gen.pruned_csr(jw, key, sparsity), dlmc_gen.pruned_csr(tw, key, sparsity, device="cpu")
        j = jformats.SellMatrix.from_csr(jc, chunk="auto", sort_rows=True)
        t = formats.SellMatrix.from_csr(tc, chunk="auto", sort_rows=True)
        jt = jformats.SellMatrix.from_csr(jc.transpose(), chunk="auto", sort_rows=True)
        np.testing.assert_array_equal(_np(t.transpose_plan.indices), np.asarray(jt.indices), err_msg=key)
        jx, tx = _dense(rng, (t.rows, 16))
        want = jsell.spmm_t(j, jx)
        _close(sell.spmm_reference(t.transpose_plan.as_sell(t.values), tx), want)
        _close(sell.spmm_t(t, tx), want)


@pytest.mark.parametrize("rows,cols,density,variant",
                         [(*shape, variant) for shape, variant in zip(SHAPES[:4], ["fused", "chunked"] * 2)])
def test_sddmm_matches_jax(rows, cols, density, variant):
    jm, tm = _pair(9, rows, cols, density)
    sort_rows = variant == "chunked"
    j = jformats.SellMatrix.from_csr(jm, sort_rows=sort_rows)
    t = formats.SellMatrix.from_csr(tm, sort_rows=sort_rows)
    rng = np.random.default_rng(10)
    (ja, ta), (jb, tb) = _dense(rng, (rows, 64)), _dense(rng, (cols, 64))
    got, want = sell.sddmm(ta, tb, t, variant=variant), jsell.sddmm(ja, jb, j, variant=variant)
    _close(got.values, want.values)
    assert not got.values[~t.valid_mask()].any()  # padding slots stay 0
    _close(csr.sddmm(ta, tb, t).values, jcsr.sddmm(ja, jb, j).values)


@pytest.mark.parametrize("sort_rows", [False, True])
@pytest.mark.parametrize("counts", [True, False])
def test_softmax_kernel_matches_jax(sort_rows, counts):
    """Both validity sources (slot_counts, the sentinel) and both variants."""
    jm, tm = _pair(11, 384, 384, 6000 / 384 ** 2)
    j = jformats.SellMatrix.from_csr(jm, sort_rows=sort_rows)
    t = formats.SellMatrix.from_csr(tm, sort_rows=sort_rows)
    if not counts:
        j, t = dataclasses.replace(j, slot_counts=None), dataclasses.replace(t, slot_counts=None)
    want = jsell.sparse_softmax(j, scale=0.5).values
    _close(sell.sparse_softmax(t, scale=0.5).values, want)
    for variant in ("pallas", "jnp"):
        _close(csr.sparse_softmax(t, scale=0.5, variant=variant).values,
               jcsr.sparse_softmax(j, scale=0.5, variant=variant).values)
    _close(csr.sparse_softmax(t).values, jcsr.sparse_softmax(j).values)  # the CPU default: the chain


def test_softmax_empty_rows_and_width():
    """A matrix with empty rows gives them all zeros, as JAX's kernel."""
    x = np.zeros((130, 140), np.float32)
    x[::3, ::7] = np.arange(1, 1 + len(range(0, 130, 3)) * 20, dtype=np.float32).reshape(-1, 20) / 50
    j = jformats.SellMatrix.from_csr(jformats.csr_from_dense(x))
    t = formats.SellMatrix.from_csr(formats.csr_from_dense(x, device="cpu"))
    _close(sell.sparse_softmax(t).values, jsell.sparse_softmax(j).values)


# --------------------------------------------------------------- dispatch --
def test_csr_dispatch_matches_jax(rng):
    """Raw CSR (converted to SELL on the host), a dense mirror, ELL, and
    transpose_b, for spmm; raw-CSR and ELL sddmm and softmax (plain)."""
    jm, tm = _pair(12, 256, 192, 0.1, pad_rows_to=4)
    jb, tb = _dense(rng, (192, 64))
    want = jcsr.spmm(jm, jb)
    _close(csr.spmm(tm, tb), want)
    _close(csr.spmm(tm.with_dense_mirror(), tb), jcsr.spmm(jm.with_dense_mirror(), jb))
    _close(csr.spmm(formats.EllMatrix.from_csr(tm), tb), jcsr.spmm(jformats.EllMatrix.from_csr(jm), jb))
    _close(csr.spmm(tm, tb.T.contiguous(), transpose_b=True), want)
    _close(csr.spmm_ell(formats.EllMatrix.from_csr(tm), tb, chunk=5),
           jcsr.spmm_ell(jformats.EllMatrix.from_csr(jm), jb, chunk=5))
    (ja, ta), (jk, tk) = _dense(rng, (256, 32)), _dense(rng, (192, 32))
    _close(csr.sddmm(ta, tk, tm).values, jcsr.sddmm(ja, jk, jm).values)
    _close(csr.sddmm(ta, tk.T, tm, transpose_b=False).values, jcsr.sddmm(ja, jk.T, jm, transpose_b=False).values)
    ell_t, ell_j = formats.EllMatrix.from_csr(tm), jformats.EllMatrix.from_csr(jm)
    _close(csr.sddmm(ta, tk, ell_t).values, jcsr.sddmm(ja, jk, ell_j).values)
    _close(csr.sparse_softmax(tm, scale=0.25).values, jcsr.sparse_softmax(jm, scale=0.25).values)
    _close(csr.sparse_softmax(ell_t, scale=0.25).values, jcsr.sparse_softmax(ell_j, scale=0.25).values)
    empty = formats.CsrMatrix.create(torch.zeros(0), np.zeros(0, np.int32), np.zeros(257, np.int32), (256, 192))
    assert not csr.spmm(empty, tb).any() and csr.sparse_softmax(empty) is empty


def test_attention_chain_matches_jax(rng):
    """sddmm -> sparse_softmax -> spmm staying in SELL (test_sell.py's chain)."""
    jm, tm = _pair(13, 256, 256, 0.08)
    j = jformats.SellMatrix.from_csr(jm, sort_rows=True)
    t = formats.SellMatrix.from_csr(tm, sort_rows=True)
    (jq, tq), (jk, tk), (jv, tv) = (_dense(rng, (256, 64)) for _ in range(3))
    for variant in ("jnp", "pallas"):
        want = jcsr.spmm(jcsr.sparse_softmax(jcsr.sddmm(jq, jk, j), scale=0.125, variant=variant), jv)
        got = csr.spmm(csr.sparse_softmax(csr.sddmm(tq, tk, t), scale=0.125, variant=variant), tv)
        _close(got.detach(), want)


def test_dlmc_attn_q_matches_jax():
    """The trained DLMC-protocol attn_q at 90%, n = 64, built as the bench
    builds it (chunk "auto", sorted rows)."""
    jw, tw = jdlmc_gen.load_weights(WEIGHTS), dlmc_gen.load_weights(WEIGHTS)
    assert set(tw) == set(jw) == set(dlmc_gen.WEIGHT_KEYS) == set(jdlmc_gen.WEIGHT_KEYS)
    assert dlmc_gen.load_provenance(WEIGHTS) == jdlmc_gen.load_provenance(WEIGHTS)
    assert dlmc_gen.SPARSITIES == jdlmc_gen.SPARSITIES
    np.testing.assert_array_equal(dlmc_gen.magnitude_prune(tw["attn_q"], 0.9),
                                  jdlmc_gen.magnitude_prune(jw["attn_q"], 0.9))
    jc, tc = jdlmc_gen.pruned_csr(jw, "attn_q", 0.9), dlmc_gen.pruned_csr(tw, "attn_q", 0.9, device="cpu")
    j = jformats.SellMatrix.from_csr(jc, chunk="auto", sort_rows=True)
    t = formats.SellMatrix.from_csr(tc, chunk="auto", sort_rows=True)
    _same_sell(t, j)
    jb, tb = _dense(np.random.default_rng(3), (512, 64))
    _close(csr.spmm(t, tb), jcsr.spmm(j, jb))


def test_synthetic_dlmc_matches_jax():
    j = jdlmc.synthetic_dlmc(np.random.default_rng(3), 256, 128, 0.9)
    t = dlmc.synthetic_dlmc(np.random.default_rng(3), 256, 128, 0.9, device="cpu")
    np.testing.assert_array_equal(_np(t.to_dense()), np.asarray(j.to_dense()))


# ----------------------------------------------------------------- checks --
def test_checks_and_dispatch():
    """JAX's argument checks, the variant names, the registry's routing on
    CPU tensors, and the kernel wrappers refusing CPU tensors."""
    _, tm = _pair(14, 256, 256, 0.1)
    s = formats.SellMatrix.from_csr(tm)
    b = torch.zeros(256, 64)
    with pytest.raises(ValueError, match="contraction"):
        sell.spmm(s, torch.zeros(255, 64))
    with pytest.raises(ValueError, match="contraction"):
        sell.spmm_t(s, torch.zeros(255, 64))
    with pytest.raises(ValueError, match="B must be"):
        sell.sddmm(b, torch.zeros(255, 64), s)
    with pytest.raises(ValueError, match="topology rows"):
        sell.sddmm(torch.zeros(255, 64), b, s)
    for bad in (dict(variant="pallas"), dict(row_tile=192), dict(row_tile=512), dict(n_tile=0)):
        with pytest.raises(ValueError):
            sell.spmm(s, b, **bad)
    with pytest.raises(ValueError, match="variant"):
        sell.sddmm(b, b, s, variant="oneshot")
    with pytest.raises(ValueError, match="variant"):
        csr.sparse_softmax(s, variant="fused")
    for kw in (dict(variant="fused", row_tile=256), dict(variant="chunked", n_tile=32)):
        torch.testing.assert_close(sell.spmm(s, b + 1, **kw), sell.spmm(s, b + 1), rtol=0, atol=0)
    assert registry.dispatch_name("sell_spmm", s, b) == "torch_reference"
    assert registry.dispatch_name("sell_softmax", s) == "torch_reference"
    with registry.forced_variant("cuda_sell"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            sell.spmm(s, b)
        with pytest.raises(ValueError, match="CUDA tensors"):
            sell.sddmm(b, b, s)


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    """Every constructor the port exposes builds on the card when given no
    device; with no card it raises, naming ``device="cpu"``."""
    from sputnik_tpu_torch.models import attention, moe
    from sputnik_tpu_torch.models import transformer as tr
    from sputnik_tpu_torch.models.convert import params_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tr.TransformerConfig(d_model=128, n_heads=1, seq_len=256, window_blocks=1, n_experts=1, d_ff=128,
                               n_layers=1, vocab=64, dtype=torch.float32)
    mcfg = moe.MoEConfig(d_model=128, d_ff=128, n_experts=1, capacity=128)
    rng = np.random.default_rng(0)
    x = np.eye(8, dtype=np.float32)
    calls = {
        "init_lm_params": lambda: tr.init_lm_params(cfg, torch.Generator()),
        "SparseLM": lambda: tr.SparseLM(cfg),
        "Block": lambda: tr.Block(cfg),
        "lm_topologies": lambda: tr.lm_topologies(cfg),
        "init_decode_caches": lambda: tr.init_decode_caches(cfg, 128),
        "MoE": lambda: moe.MoE(mcfg),
        "init_moe_params": lambda: moe.init_moe_params(mcfg, torch.Generator()),
        "block_diag_topology": lambda: moe.block_diag_topology(mcfg),
        "band_topology": lambda: attention.band_topology(256, 1),
        "causal_block_topology": lambda: attention.causal_block_topology(256),
        "params_from_numpy": lambda: params_from_numpy({}, cfg),
        "csr_from_dense": lambda: formats.csr_from_dense(x),
        "random_csr": lambda: testing.random_csr(rng, 8, 8, 8),
        "random_bsr": lambda: testing.random_bsr(rng, 128, 128, 128 * 128, 128),
        "bsr_from_blocks": lambda: testing.bsr_from_blocks(128, 128, [0], [0], np.ones((1, 128, 128))),
        "synthetic_dlmc": lambda: dlmc.synthetic_dlmc(rng, 64, 64),
        "pruned_csr": lambda: dlmc_gen.pruned_csr({"attn_q": x}, "attn_q", 0.5),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
            pytest.fail(f"{name} built without a card")
    # Given a device, they build there; a tensor keeps its own device.
    assert formats.csr_from_dense(x, device="cpu").device.type == "cpu"
    assert formats.SellMatrix.from_csr(formats.csr_from_dense(torch.from_numpy(x))).device.type == "cpu"


@pytest.mark.parametrize("empty_row", [False, True])
def test_sparse_softmax_without_hint_matches_jax(empty_row):
    """The raw-CSR softmax needs no max_row_nnz hint (offsets built on the
    card carry none): the hint dropped, it matches JAX's segment max / sum
    at softmax tolerance, an empty row included, and its gradient flows."""
    jm, tm = _pair(31, 192, 160, 0.08, pad_rows_to=2)
    if empty_row:  # row 5 loses its entries
        offs = np.asarray(jm.offsets)
        keep = np.ones(jm.nnz, bool)
        keep[offs[5]:offs[6]] = False
        counts = np.diff(offs)
        counts[5] = 0
        new_offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        vals, idx = np.asarray(jm.values)[keep], np.asarray(jm.indices)[keep]
        jm = jformats.CsrMatrix.create(jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(new_offs), jm.shape)
        tm = formats.CsrMatrix.create(torch.from_numpy(vals), idx, new_offs, tm.shape)
    tm = dataclasses.replace(tm, max_row_nnz=None)
    values = tm.values.clone().requires_grad_()
    got = csr.sparse_softmax(tm.with_values(values), scale=0.5).values
    want = np.asarray(jcsr.sparse_softmax(jm, scale=0.5).values)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)
    got.sum().backward()
    assert torch.isfinite(values.grad).all()
    np.testing.assert_allclose(_np(csr.sparse_softmax(tm.transpose()).values),
                               np.asarray(jcsr.sparse_softmax(jm.transpose()).values), atol=1e-5, rtol=1e-5)
