"""The port's distributed layer (sputnik_tpu_torch.parallel) against the JAX
package's: the host partitioners give exactly JAX's metadata and data, and
each sharded op, on a 2- and a 4-rank gloo group (one spawn per world size
runs every case), matches JAX's shard_map op on a 2- / 4-device sub-mesh of
the CPU mesh. The one-process sequential drive of the ranks' bodies equals
the gloo run."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch

from sputnik_tpu import parallel as jpar
from sputnik_tpu.formats import bsr_from_dense as j_bsr_from_dense
from sputnik_tpu.models import attention as jattn
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import parallel as tpar
from sputnik_tpu_torch.formats import bsr_from_dense as t_bsr_from_dense
from sputnik_tpu_torch.models import attention as tattn
from sputnik_tpu_torch.parallel import sharding as tsharding
from sputnik_tpu_torch.utils import testing as ttesting
from sputnik_tpu_torch.utils.testing import ATOL

F32 = dict(atol=1e-4, rtol=1e-5)


def _mesh(s):
    return Mesh(np.array(jax.devices()[:s]), ("x",))


def _bsr(seed, rows, cols, density):
    nnz = int(rows * cols * density)
    return (jtesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, 128),
            ttesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, 128, device="cpu"))


def _csr(seed, rows, cols, density):
    nnz = int(rows * cols * density)
    return (jtesting.random_csr(np.random.default_rng(seed), rows, cols, nnz),
            ttesting.random_csr(np.random.default_rng(seed), rows, cols, nnz, device="cpu"))


def _skewed():
    """1024 x 1024 with one full block-row band and one block: at S = 4,
    shards 1 and 3 are empty."""
    rng = np.random.default_rng(5)
    dense = np.zeros((1024, 1024), np.float32)
    dense[:128, :] = rng.standard_normal((128, 1024))
    dense[512:640, :128] = rng.standard_normal((128, 128))
    return j_bsr_from_dense(dense, 128), t_bsr_from_dense(dense, 128, device="cpu"), dense


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _same(jx, tx, fields):
    for f in fields:
        a, b = getattr(jx, f), getattr(tx, f)
        if isinstance(a, (int, str, tuple)) or a is None:
            assert a == b, f
        else:
            np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32 if f in ("data", "values") else None),
                                          err_msg=f)


# ------------------------------------------------------------ partitioners --
BSR_FIELDS = ("data", "offsets", "indices", "row_indices", "shape", "block_size", "n_shards", "max_row_nnz")


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("kind", ["random", "skewed"])
def test_partition_bsr_matches_jax(kind, s):
    if kind == "skewed":
        jm, tm, _ = _skewed()
    else:
        jm, tm = _bsr(0, 1024, 512, 0.3)
    js, ts = jpar.partition_bsr_rows(jm, s), tpar.partition_bsr_rows(tm, s)
    _same(js, ts, BSR_FIELDS + ("valid_counts",))
    jt, tt = jpar.partition_topology_rows(jm, s), tpar.partition_topology_rows(tm, s)
    _same(jt, tt, BSR_FIELDS + ("valid_counts",))
    if kind == "random":
        np.testing.assert_array_equal(_np(ts.local_matrix(1).to_dense()), np.asarray(js.local_matrix(1).to_dense()))
    elif s == 4:
        assert ts.valid_counts.tolist() == [8, 0, 1, 0]  # two empty shards, padded
    jb, tb = jpar.partition_bsr_rows_kbands(jm, s), tpar.partition_bsr_rows_kbands(tm, s)
    _same(jb, tb, BSR_FIELDS)


@pytest.mark.parametrize("s", [2, 4])
def test_partition_csr_and_sell_match_jax(s):
    jm, tm = _csr(1, 512, 512, 0.05)
    _same(jpar.partition_csr_rows(jm, s), tpar.partition_csr_rows(tm, s),
          ("values", "indices", "offsets", "row_indices", "shape", "n_shards"))
    sell_fields = ("values", "indices", "shape", "chunk", "n_shards", "partition")
    _same(jpar.partition_sell_rows(jm, s), tpar.partition_sell_rows(tm, s), sell_fields)
    _same(jpar.partition_sell_cols(jm, s), tpar.partition_sell_cols(tm, s), sell_fields)
    _same(jpar.partition_sell_rows(jm, s, chunk=64), tpar.partition_sell_rows(tm, s, chunk=64), sell_fields)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("kind", ["band", "causal", "random", "skewed"])
def test_partition_ring_matches_jax(kind, s):
    seq = 4 * 256
    if kind == "band":
        jt, tt = jattn.band_topology(seq, 3, 128), tattn.band_topology(seq, 3, 128, device="cpu")
    elif kind == "causal":
        jt = jattn.causal_block_topology(seq, 128, window_blocks=4)
        tt = tattn.causal_block_topology(seq, 128, window_blocks=4, device="cpu")
    elif kind == "random":
        jt, tt = _bsr(2, seq, seq, 0.25)
    else:
        jt, tt, _ = _skewed()
    jr, tr_ = jpar.partition_topology_ring(jt, s), tpar.partition_topology_ring(tt, s)
    for f in ("rows", "cols", "valid"):
        np.testing.assert_array_equal(_np(getattr(tr_, f)), np.asarray(getattr(jr, f)), err_msg=f)
    assert (tr_.n_shards, tr_.band_blocks, tr_.block_size) == (jr.n_shards, jr.band_blocks, jr.block_size)


def test_partitioners_raise_as_jax():
    jm, tm = _bsr(3, 3 * 128, 3 * 128, 0.5)
    for part in ("partition_bsr_rows", "partition_bsr_rows_kbands", "partition_topology_rows",
                 "partition_topology_ring"):
        for pkg in (jpar, tpar):
            with pytest.raises(ValueError, match="divisible"):
                getattr(pkg, part)(jm if pkg is jpar else tm, 2)
    jm, tm = _bsr(3, 1024, 640, 0.2)  # K does not split into 8 bands
    for pkg, m in ((jpar, jm), (tpar, tm)):
        with pytest.raises(ValueError, match="divisible"):
            pkg.partition_bsr_rows_kbands(m, 8)
    jc, tc = _csr(4, 256, 300, 0.02)
    for pkg, m in ((jpar, jc), (tpar, tc)):
        with pytest.raises(ValueError, match="divisible"):
            pkg.partition_sell_cols(m, 4)
        with pytest.raises(ValueError, match="divisible"):
            pkg.partition_csr_rows(m, 3)


# ------------------------------------------------------------ sharded ops --
def _inputs(s):
    """Per world size: the JAX and port operands of every case, as
    {name: (jax thunk, port case, tolerance)}; the port case is the
    (op, args, kwargs, sharded) of utils.testing.parallel_cases."""
    rng = np.random.default_rng(10 + s)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    mesh = _mesh(s)
    jm, tm = _bsr(20 + s, 512, 512, 0.4)
    b = f32(512, 128)
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    js, ts = jpar.partition_bsr_rows(jm, s), tpar.partition_bsr_rows(tm, s)
    jk, tk = jpar.partition_bsr_rows_kbands(jm, s), tpar.partition_bsr_rows_kbands(tm, s)
    _, tsk, skew = _skewed()
    bsk = f32(1024, 128)
    a_sdd, b_sdd = f32(512, 256), f32(256, 512)
    jc, tc = _csr(30 + s, 512, 512, 0.08)
    bc = f32(512, 64)
    bf = torch.from_numpy(b).to(torch.bfloat16)
    jmb = jm.with_data(jm.data.astype(jnp.bfloat16))
    tmb = tm.astype(torch.bfloat16)
    cases = {
        "dsd": (lambda: jpar.sharded_dsd(js, jb, mesh), ("sharded_dsd", [ts, tb], {}, ()), F32),
        "dsd_kshard": (lambda: jpar.sharded_dsd(js, jb, mesh, b_sharded_k=True),
                       ("sharded_dsd", [ts, tb], {"b_sharded_k": True}, (1,)), F32),
        "dsd_bf16": (lambda: jpar.sharded_dsd(jpar.partition_bsr_rows(jmb, s), jb.astype(jnp.bfloat16), mesh,
                                              out_dtype=jnp.float32),
                     ("sharded_dsd", [tpar.partition_bsr_rows(tmb, s), bf], {"out_dtype": torch.float32}, ()),
                     dict(atol=ATOL)),
        "dsd_ring": (lambda: jpar.sharded_dsd_ring(jk, jb, mesh), ("sharded_dsd_ring", [tk, tb], {}, (1,)), F32),
        # Against the fp64 oracle (JAX's test_sharded_dsd_ring_skewed_rows).
        "dsd_ring_skewed": (None, ("sharded_dsd_ring", [tpar.partition_bsr_rows_kbands(tsk, s), torch.from_numpy(bsk)],
                                   {}, (1,)), dict(atol=ATOL)),
        "sdd": (lambda: jpar.sharded_sdd(jnp.asarray(a_sdd), jnp.asarray(b_sdd), js, mesh).data,
                ("sharded_sdd", [torch.from_numpy(a_sdd), torch.from_numpy(b_sdd), ts], {}, (0,)), F32),
        "spmm_sell": (lambda: jpar.sharded_spmm_sell(jpar.partition_sell_rows(jc, s), jnp.asarray(bc), mesh),
                      ("sharded_spmm_sell", [tpar.partition_sell_rows(tc, s), torch.from_numpy(bc)], {}, ()), F32),
        "spmm_sell_kshard_b": (
            lambda: jpar.sharded_spmm_sell(jpar.partition_sell_rows(jc, s), jnp.asarray(bc), mesh, b_sharded_k=True),
            ("sharded_spmm_sell", [tpar.partition_sell_rows(tc, s), torch.from_numpy(bc)], {"b_sharded_k": True},
             (1,)), F32),
        "spmm_kshard": (lambda: jpar.sharded_spmm_kshard(jpar.partition_sell_cols(jc, s), jnp.asarray(bc), mesh,
                                                         out_dtype=jnp.float32),
                        ("sharded_spmm_kshard", [tpar.partition_sell_cols(tc, s), torch.from_numpy(bc)],
                         {"out_dtype": torch.float32}, (1,)), F32),
        "spmm_csr": (lambda: jpar.sharded_spmm(jpar.partition_csr_rows(jc, s), jnp.asarray(bc), mesh),
                     ("sharded_spmm", [tpar.partition_csr_rows(tc, s), torch.from_numpy(bc)], {}, ()), F32),
    }
    # JAX's validation (tests/test_parallel.py:174): contraction mismatch
    # and a shard count the group does not have.
    errors = {
        "ring_contraction": ("sharded_dsd_ring", [tk, torch.zeros(256, 64)], {}, (1,)),
        "ring_shards": ("sharded_dsd_ring", [tpar.partition_bsr_rows_kbands(tsk, 2 * s), torch.from_numpy(bsk)], {},
                        (1,)),
        "dsd_shards": ("sharded_dsd", [tpar.partition_bsr_rows(tsk, 2 * s), torch.from_numpy(bsk)], {}, ()),
        "kshard_rows": ("sharded_spmm_kshard", [tpar.partition_sell_rows(tc, s), torch.from_numpy(bc)], {}, (1,)),
    }
    return cases, errors, skew, bsk


@pytest.fixture(scope="module")
def worlds():
    """{S: (cases, errors, gloo results by name, JAX results by name)}."""
    out = {}
    for s in (2, 4):
        cases, errors, skew, bsk = _inputs(s)
        names = list(cases) + list(errors)
        port = [cases[n][1] for n in cases] + [errors[n] for n in errors]
        ranks = ttesting.run_spmd(ttesting.parallel_cases, s, port)
        got = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
        want = {n: np.asarray(jnp.asarray(c[0]()).astype(jnp.float32)) for n, c in cases.items() if c[0]}
        want["dsd_ring_skewed"] = jtesting.dense_oracle_matmul(skew, bsk)
        out[s] = (cases, errors, got, want)
    return out


OPS = ("dsd", "dsd_kshard", "dsd_bf16", "dsd_ring", "dsd_ring_skewed", "sdd", "spmm_sell", "spmm_sell_kshard_b",
       "spmm_kshard", "spmm_csr")


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", OPS)
def test_sharded_op_matches_jax(worlds, s, name):
    cases, _, got, want = worlds[s]
    tol = cases[name][2]
    out = np.concatenate(got[name])
    np.testing.assert_allclose(out, want[name].reshape(out.shape), **tol)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", ["ring_contraction", "ring_shards", "dsd_shards", "kshard_rows"])
def test_sharded_op_raises_as_jax(worlds, s, name):
    _, _, got, _ = worlds[s]
    match = {"ring_contraction": "contraction mismatch", "kshard_rows": "column-partitioned"}.get(name, "shards")
    for rank_result in got[name]:
        assert rank_result[:2] == ("raised", "ValueError") and match in rank_result[2], rank_result


SEQUENTIAL = {
    "dsd": tsharding.sharded_dsd_sequential, "dsd_kshard": tsharding.sharded_dsd_sequential,
    "dsd_ring": tsharding.sharded_dsd_ring_sequential, "sdd": tsharding.sharded_sdd_sequential,
    "spmm_sell": tsharding.sharded_spmm_sell_sequential, "spmm_csr": tsharding.sharded_spmm_sequential,
    "spmm_kshard": tsharding.sharded_spmm_kshard_sequential,
}


@pytest.mark.parametrize("name", list(SEQUENTIAL))
def test_sequential_drive_equals_gloo(worlds, name):
    """The one-process drive of the ranks' bodies gives each rank's gloo
    output bitwise; the K-sharded SpMM's reduce-scatter may sum its S
    partials in another order, so it is held at fp32 tolerance."""
    cases, _, got, _ = worlds[4]
    _, args, kwargs, _ = cases[name][1]
    kwargs = {k: v for k, v in kwargs.items() if k != "b_sharded_k"}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: CPU matmuls sum in another order on more threads
    try:
        outs = SEQUENTIAL[name](*args, **kwargs)
    finally:
        torch.set_num_threads(threads)
    for s, (seq, gloo) in enumerate(zip(outs, got[name])):
        seq = ttesting._to_numpy(seq)
        if name == "spmm_kshard":
            np.testing.assert_allclose(seq, gloo, **F32)
        else:
            np.testing.assert_array_equal(seq, gloo, err_msg=f"rank {s}")
