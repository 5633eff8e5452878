"""The port's DSD / DDS / SDD, registry and BSR softmax against the JAX package.

The same numpy inputs go through both packages. JAX runs on the CPU as its
own tests run it (Pallas in interpret mode: first-fit reaches pallas_stream
and pallas_panel); the port runs its plain versions. Tolerances: fp32 atol
1e-4 and rtol 1e-5 against JAX (the same fp32 products summed in another
order, up to K = 1024 terms of outputs up to ~40 in size) and the reference
contract ATOL against the fp64 oracle.

The CUDA kernels are held against their plain versions on the card in
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import ops as jops
from sputnik_tpu.kernels import reference as jreference
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import ops
from sputnik_tpu_torch.kernels import bsr_dsd, bsr_sdd
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.testing import ATOL

BS = 128
MODES = [(False, False), (False, True), (True, False), (True, True)]
# (m, k, n, density, unordered): tests/test_bsr_matmul.py PROBLEMS[3], [5], [7].
PROBLEMS = [
    (512, 512, 256, 0.5, False),
    (512, 512, 512, 0.25, True),
    (128, 1024, 128, 0.25, True),
]
JAX_TOL = dict(atol=1e-4, rtol=1e-5)


def _sparse(seed, rows, cols, density, unordered):
    nnz = max(int(rows * cols * density), BS * BS)
    jm = jtesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, unordered=unordered)
    tm = testing.random_bsr(np.random.default_rng(seed), rows, cols, nnz, BS, unordered=unordered, device="cpu")
    return jm, tm


def _dense(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _dims(m, k, n, ta, tb):
    return ((k, m) if ta else (m, k)), ((n, k) if tb else (k, n))


@pytest.mark.parametrize("ta,tb", MODES)
@pytest.mark.parametrize("m,k,n,density,unordered", PROBLEMS)
def test_dsd_matches_jax(rng, m, k, n, density, unordered, ta, tb):
    a_shape, b_shape = _dims(m, k, n, ta, tb)
    ja, ta_ = _sparse(1, *a_shape, density, unordered)
    jb, tb_ = _dense(rng, b_shape)
    expected = np.asarray(jops.dsd(ja, jb, transpose_a=ta, transpose_b=tb))
    out = ops.dsd(ta_, tb_, transpose_a=ta, transpose_b=tb)
    np.testing.assert_allclose(out.numpy(), expected, **JAX_TOL)
    oracle = testing.dense_oracle_matmul(ta_.to_dense().numpy(), tb_.numpy(), transpose_a=ta, transpose_b=tb)
    np.testing.assert_allclose(out.numpy(), oracle, atol=ATOL)


@pytest.mark.parametrize("ta,tb", MODES)
@pytest.mark.parametrize("m,k,n,density,unordered", PROBLEMS)
def test_dds_matches_jax(rng, m, k, n, density, unordered, ta, tb):
    a_shape, b_shape = _dims(m, k, n, ta, tb)
    ja, ta_ = _dense(rng, a_shape)
    jb, tb_ = _sparse(2, *b_shape, density, unordered)
    expected = np.asarray(jops.dds(ja, jb, transpose_a=ta, transpose_b=tb))
    out = ops.dds(ta_, tb_, transpose_a=ta, transpose_b=tb)
    np.testing.assert_allclose(out.numpy(), expected, **JAX_TOL)
    oracle = testing.dense_oracle_matmul(ta_.numpy(), tb_.to_dense().numpy(), transpose_a=ta, transpose_b=tb)
    np.testing.assert_allclose(out.numpy(), oracle, atol=ATOL)


@pytest.mark.parametrize("ta,tb", MODES)
@pytest.mark.parametrize("m,k,n,density,unordered", PROBLEMS)
def test_sdd_matches_jax(rng, m, k, n, density, unordered, ta, tb):
    a_shape, b_shape = _dims(m, k, n, ta, tb)
    ja, ta_ = _dense(rng, a_shape)
    jb, tb_ = _dense(rng, b_shape)
    jt, tt = _sparse(3, m, n, density, unordered)
    expected = jops.sdd(ja, jb, jt, transpose_a=ta, transpose_b=tb)
    out = ops.sdd(ta_, tb_, tt, transpose_a=ta, transpose_b=tb)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(expected.indices))
    np.testing.assert_allclose(out.data.numpy(), np.asarray(expected.data), **JAX_TOL)
    full = testing.dense_oracle_matmul(ta_.numpy(), tb_.numpy(), transpose_a=ta, transpose_b=tb)
    oracle = np.asarray(jreference.extract_blocks(jnp.asarray(full.astype(np.float32)), jt))
    np.testing.assert_allclose(out.data.numpy(), oracle, atol=ATOL)


@pytest.mark.parametrize("op", ["dsd", "dds", "sdd"])
def test_dispatch_matches_jax_detour_and_cpu_variant(rng, op):
    """Near-dense operands take the densify detour in both packages; other
    CPU problems take the plain version (JAX: a Pallas kernel)."""
    for density, torch_name in ((1.0, "xla_dense_detour"), (0.25, "torch_reference")):
        js, ts = _sparse(4, 512, 512, density, False)
        jd, td = _dense(rng, (512, 512))
        jargs, targs = {"dsd": ((js, jd), (ts, td)), "dds": ((jd, js), (td, ts)),
                        "sdd": ((jd, jd, js), (td, td, ts))}[op]
        assert registry.dispatch_name(op, *targs) == torch_name
        jname = jops.registry.dispatch_name(op, *jargs)
        assert (jname == "xla_dense_detour") == (torch_name == "xla_dense_detour"), jname


def test_registry_variant_override_and_errors(rng):
    _, ts = _sparse(5, 256, 256, 0.5, False)
    td = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    out = ops.dsd(ts, td, variant="torch_reference")
    np.testing.assert_allclose(out.numpy(), bsr_dsd.dsd_reference(ts, td).numpy())
    with registry.forced_variant("xla_dense_detour"):
        assert registry.dispatch_name("dsd", ts, td) == "xla_dense_detour"
    assert registry.dispatch_name("dsd", ts, td) == "torch_reference"
    with pytest.raises(ValueError, match="no variant named"):
        ops.dsd(ts, td, variant="nope")
    with pytest.raises(ValueError, match="contraction mismatch"):
        ops.dsd(ts, td.T.contiguous()[:, :128])
    # A device no variant takes: the full problem dump, as in the JAX registry.
    meta = ts.to("meta")
    with pytest.raises(NotImplementedError, match="variants tried"):
        ops.dsd(meta, td.to("meta"))


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    _, ts = _sparse(6, 256, 256, 0.5, False)
    td = torch.zeros(256, 128)
    with pytest.raises(ValueError, match="CUDA"):
        bsr_dsd.stream(ts, td, torch.empty(256, 128), transpose_sparse=False,
                       transpose_dense=False, out_transposed=False)
    with pytest.raises(ValueError, match="CUDA"):
        bsr_sdd.launch(torch.zeros(256, 128), torch.zeros(256, 128), ts, torch.empty(ts.data.shape),
                       transpose_a=False, transpose_b=True)
    assert bsr_dsd.LAUNCHES == 0 and bsr_sdd.LAUNCHES == 0


def test_kernel_wrappers_on_cpu_give_plain_versions_and_refuse_unknown_options(rng):
    """On CPU tensors dsd/dds/sdd compute their plain versions; the stream
    kernel's ``out_scale`` (the int8 dequantization, JAX's hook) scales the
    flush there too, while the differentiable op, which no variant of it
    scales, and an option no kernel implements raise rather than being
    dropped."""
    _, ts = _sparse(8, 256, 256, 0.5, True)
    td = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    launches = bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES
    for ta, tb in MODES:
        kw = dict(transpose_a=ta, transpose_b=tb)
        torch.testing.assert_close(bsr_dsd.dsd(ts, td, **kw), bsr_dsd.dsd_reference(ts, td, **kw), atol=0, rtol=0)
        torch.testing.assert_close(bsr_dsd.dds(td, ts, **kw), bsr_dsd.dds_reference(td, ts, **kw), atol=0, rtol=0)
        torch.testing.assert_close(bsr_sdd.sdd(td, td, ts, **kw).data,
                                   bsr_sdd.sdd_reference(td, td, ts, **kw).data, atol=0, rtol=0)
    assert (bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES) == launches
    torch.testing.assert_close(bsr_dsd.dsd(ts, td, out_scale=2.0), 2 * bsr_dsd.dsd(ts, td), atol=0, rtol=0)
    with pytest.raises(TypeError, match="n_tile"):
        bsr_dsd.dsd(ts, td, n_tile=256)
    with pytest.raises(TypeError, match="out_scale"):
        ops.dsd(ts, td, out_scale=2.0)


def test_batched_ops_match_per_entry(rng):
    """A leading batch axis (attention heads) equals one call per entry."""
    _, ts = _sparse(7, 512, 512, 0.25, True)
    data = torch.from_numpy(rng.standard_normal((3,) + tuple(ts.data.shape)).astype(np.float32))
    dense = torch.from_numpy(rng.standard_normal((3, 512, 256)).astype(np.float32))
    out = ops.dsd(ts.with_data(data), dense)
    scores = ops.sdd(dense, dense, ts, transpose_b=True)
    for i in range(3):
        torch.testing.assert_close(out[i], ops.dsd(ts.with_data(data[i]), dense[i]))
        torch.testing.assert_close(scores.data[i], ops.sdd(dense[i], dense[i], ts, transpose_b=True).data)


@pytest.mark.parametrize("causal", [False, True])
def test_bsr_softmax_matches_jax(rng, causal):
    from sputnik_tpu.models.attention import causal_block_topology as jcausal
    from sputnik_tpu.ops.softmax import bsr_softmax as jsoftmax
    from sputnik_tpu_torch.models.attention import causal_block_topology

    jt = jcausal(512, window_blocks=2, dtype=jnp.float32)
    tt = causal_block_topology(512, window_blocks=2, dtype=torch.float32, device="cpu")
    x = (rng.standard_normal(tuple(tt.data.shape)) * 3).astype(np.float32)
    expected = np.asarray(jsoftmax(jt.with_data(jnp.asarray(x)), scale=0.5, causal=causal).data)
    out = ops.bsr_softmax(tt.with_data(torch.from_numpy(x)), scale=0.5, causal=causal)
    np.testing.assert_allclose(out.data.numpy(), expected, atol=1e-5)
    # Batched data normalizes each entry on its own.
    both = ops.bsr_softmax(tt.with_data(torch.from_numpy(np.stack([x, 2 * x]))), scale=0.5, causal=causal)
    np.testing.assert_allclose(both.data[0].numpy(), expected, atol=1e-5)


def test_bsr_softmax_empty_rows_stay_finite():
    # Block-row 0 holds only a block above the diagonal (fully masked when
    # causal); block-row 1 holds nothing.
    m = testing.bsr_from_blocks(256, 256, [0], [1], np.ones((1, BS, BS)), device="cpu")
    out = ops.bsr_softmax(m, causal=True)
    assert torch.isfinite(out.data).all() and float(out.data.abs().max()) == 0.0
