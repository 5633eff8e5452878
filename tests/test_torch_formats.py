"""The port's BSR format and metadata against the JAX package: the same
numpy-seeded matrices must give exactly equal int32 metadata."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import formats as jformats
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import formats
from sputnik_tpu_torch.utils import testing

BS = 128

# (rows, cols, density, unordered): a subset of tests/test_bsr_matmul.py's grid,
# plus a pattern with empty block-rows and block-columns.
SHAPES = [
    (128, 256, 1.0, False),
    (512, 512, 0.5, False),
    (512, 512, 0.25, True),
    (1024, 128, 0.5, False),
    (128, 1024, 0.25, True),
    (1024, 512, 0.1, True),
]


def _pair(seed, rows, cols, density, unordered):
    nnz = max(int(rows * cols * density), BS * BS)
    kw = dict(unordered=unordered)
    jm = jtesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, dtype=jnp.float32, **kw)
    tm = testing.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, device="cpu", **kw)
    return jm, tm


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.dtype == torch.int32


@pytest.mark.parametrize("rows,cols,density,unordered", SHAPES)
def test_metadata_matches_jax(rows, cols, density, unordered):
    jm, tm = _pair(7, rows, cols, density, unordered)
    np.testing.assert_array_equal(tm.data.numpy(), np.asarray(jm.data))
    for name in ("offsets", "indices", "row_indices"):
        _eq(getattr(tm, name), getattr(jm, name))
    jt, tt = jm.with_transpose_metadata(), tm.with_transpose_metadata()
    for name in ("offsets_t", "indices_t", "block_offsets"):
        _eq(getattr(tt, name), getattr(jt, name))
    for transposed in (False, True):
        for t, j in zip(tm.iteration_arrays(transposed), jm.iteration_arrays(transposed)):
            _eq(t, j)
    for hint in ("max_row_nnz", "max_col_nnz", "min_row_nnz", "min_col_nnz"):
        assert getattr(tm, hint) == getattr(jm, hint), hint
    assert tm.density == jm.density
    np.testing.assert_array_equal(tm.to_dense().numpy(), np.asarray(jm.to_dense()))


def test_bsr_from_dense_matches_jax(rng):
    x = rng.standard_normal((512, 384)).astype(np.float32)
    x[:128, 128:256] = 0  # one pruned block
    x[256:384] = 0  # one empty block-row
    jm = jformats.bsr_from_dense(x, BS)
    tm = formats.bsr_from_dense(torch.from_numpy(x), BS)
    for name in ("offsets", "indices", "row_indices"):
        _eq(getattr(tm, name), getattr(jm, name))
    np.testing.assert_array_equal(tm.to_dense().numpy(), x)
    assert tm.min_row_nnz == 0


def test_batched_data_densifies_per_entry(rng):
    tm = testing.random_bsr(rng, 512, 256, 512 * 256 // 3, BS, unordered=True, device="cpu")
    batch = torch.from_numpy(rng.standard_normal((3,) + tuple(tm.data.shape)).astype(np.float32))
    dense = tm.with_data(batch).to_dense()
    assert dense.shape == (3, 512, 256)
    for i in range(3):
        np.testing.assert_array_equal(dense[i].numpy(), tm.with_data(batch[i]).to_dense().numpy())


def test_create_validates_and_moves(rng):
    with pytest.raises(ValueError, match="divisible"):
        formats.BlockSparseMatrix.create(torch.zeros(1, BS, BS), [0, 1], [0], (BS + 1, BS))
    with pytest.raises(ValueError, match="does not fit"):
        testing.random_bsr(rng, 256, 256, BS * BS, BS, device="cpu").with_data(torch.zeros(2, 64, 64))
    m = testing.random_bsr(rng, 256, 256, 2 * BS * BS, BS, device="cpu").with_transpose_metadata().to("cpu")
    assert all(t.device.type == "cpu" for t in (m.data, m.offsets, m.offsets_t, m.block_offsets))


def test_port_never_imports_jax():
    code = (
        "import sys, sputnik_tpu_torch, sputnik_tpu_torch.models, sputnik_tpu_torch.kernels.bsr_dsd, "
        "sputnik_tpu_torch.kernels.bsr_sdd, sputnik_tpu_torch.models.convert, sputnik_tpu_torch.kernels.sell, "
        "sputnik_tpu_torch.ops.csr, sputnik_tpu_torch.utils.dlmc, sputnik_tpu_torch.utils.dlmc_gen, "
        "sputnik_tpu_torch.bench.dlmc, sputnik_tpu_torch.bench.moe, chip_smoke; "
        "bad = [m for m in sys.modules if m in ('jax', 'sputnik_tpu') or m.startswith(('jax.', 'sputnik_tpu.'))]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parent.parent,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("dim,preferred", [(128, 512), (384, 256), (4096, 4096), (1280, 512)])
def test_tile_helpers_match_jax(dim, preferred):
    from sputnik_tpu.kernels import common as jcommon
    from sputnik_tpu_torch.kernels import common

    assert common.pick_tile(dim, preferred) == jcommon.pick_tile(dim, preferred)
    assert common.cdiv(dim, preferred) == jcommon.cdiv(dim, preferred)
    assert common.round_up(dim + 1, preferred) == jcommon.round_up(dim + 1, preferred)
    with pytest.raises(ValueError, match="not a multiple"):
        common.pick_tile(dim + 64, preferred)
