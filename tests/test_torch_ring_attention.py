"""The port's band fold, ring attention and sequence-parallel attention
against the JAX package's: ``flash_band_fold_reference`` against JAX's
``flash_band_fold`` (interpret mode) on the same state and slots, and
``ring_block_sparse_attention`` / ``sharded_block_sparse_attention`` on a
4-rank gloo group (one spawn runs every case) against JAX's shard_map ops on
a 4-device sub-mesh, on JAX's test topologies at its smallest shapes. The
one-process sequential drive of the ranks' bodies equals the gloo run
bitwise."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch

from sputnik_tpu import parallel as jpar
from sputnik_tpu.kernels.flash_attention import flash_band_fold as j_fold
from sputnik_tpu.models import attention as jattn
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import parallel as tpar
from sputnik_tpu_torch.kernels.flash_attention import flash_band_fold, flash_band_fold_reference
from sputnik_tpu_torch.models import attention as tattn
from sputnik_tpu_torch.parallel import attention as tpattn
from sputnik_tpu_torch.parallel import ring_attention as tring
from sputnik_tpu_torch.utils import testing as ttesting
from sputnik_tpu_torch.utils.testing import ATOL

S = 4


# ------------------------------------------------------------ the fold --
def _fold_inputs(rng, dh, carried):
    t = tk = 512
    q, k, v = (rng.standard_normal((n, dh)).astype(np.float32) for n in (t, tk, tk))
    # Block-rows 0 and 2 have real slots; row 1 only padding; row 3 none.
    rows = np.array([0, 0, 1, 2, 2, 2, 2], np.int32)
    cols = np.array([1, 3, 0, 0, 2, 3, 3], np.int32)
    flags = np.array([1, 1, 0, 1, 1, 1, 0], np.int32)
    if carried:  # a state as an earlier fold leaves it, lanes 1-127 arbitrary
        acc = rng.standard_normal((t, dh)).astype(np.float32)
        m = rng.standard_normal((t, 128)).astype(np.float32)
        l = (1.0 + np.abs(rng.standard_normal((t, 128)))).astype(np.float32)
    else:
        acc = np.zeros((t, dh), np.float32)
        m = np.full((t, 128), -1e30, np.float32)
        l = np.zeros((t, 128), np.float32)
    return (q, k, v, rows, cols, flags), (acc, m, l)


FOLD_CASES = {
    # name: (dh, causal, row_offset_blocks, col_offset_blocks, carried, all padding)
    "causal_diagonal_dh64": (64, True, 0, 0, False, False),
    "causal_offsets_dh128": (128, True, 2, 1, False, False),
    "causal_carried_state": (64, True, 1, 0, True, False),
    "noncausal_dh128": (128, False, 0, 0, False, False),
    "noncausal_carried_offsets": (64, False, 3, 2, True, False),
    "all_padding": (64, True, 1, 1, True, True),
}


@pytest.mark.parametrize("name", list(FOLD_CASES))
def test_fold_reference_matches_jax(name):
    dh, causal, ro, co, carried, padding = FOLD_CASES[name]
    rng = np.random.default_rng(sorted(FOLD_CASES).index(name))
    ops_, state = _fold_inputs(rng, dh, carried)
    if padding:
        ops_ = ops_[:5] + (np.zeros_like(ops_[5]),)
    kw = dict(bs=128, scale=dh ** -0.5, causal=causal, row_offset_blocks=ro, col_offset_blocks=co)
    want = j_fold(*(jnp.asarray(x) for x in ops_), tuple(jnp.asarray(x) for x in state), **kw)
    got = flash_band_fold(*(torch.from_numpy(x) for x in ops_), tuple(torch.from_numpy(x) for x in state), **kw)
    got_ref = flash_band_fold_reference(*(torch.from_numpy(x) for x in ops_), tuple(torch.from_numpy(x) for x in state),
                                        **kw)
    for g, r in zip(got, got_ref):  # on the CPU the wrapper is the plain version
        assert torch.equal(g, r)
    (acc, m, l), (jacc, jm, jl) = (x.numpy() for x in got), (np.asarray(x) for x in want)
    np.testing.assert_allclose(acc, jacc, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(l[:, 0], jl[:, 0], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(m[:, 0], jm[:, 0], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(m[:, 1:], jm[:, 1:])  # lanes 1-127 pass through
    np.testing.assert_array_equal(l[:, 1:], jl[:, 1:])
    np.testing.assert_array_equal(m[:, 1:], state[1][:, 1:])
    unvisited = np.ones(4, bool)
    unvisited[np.unique(ops_[3][ops_[5] > 0])] = False
    rows = np.repeat(unvisited, 128)
    for x, x0 in zip((acc, m, l), state):  # rows with no real slot keep their input
        np.testing.assert_array_equal(x[rows], x0[rows])


def test_ring_causal_requires_fused():
    topo = tpar.partition_topology_ring(tattn.band_topology(512, 2, 128, dtype=torch.float32, device="cpu"), S)
    q = torch.zeros(512, 64)
    with pytest.raises(ValueError, match="causal"):
        tpar.ring_block_sparse_attention(q, q, q, topo, causal=True, fused=False)
    with pytest.raises(ValueError, match="causal"):
        tring.ring_block_sparse_attention_sequential(q, q, q, topo, causal=True, fused=False)


# ----------------------------------------------- ring and sharded attention --
def _topologies():
    """JAX's test topologies (tests/test_ring_attention.py,
    test_parallel_sell.py) in both packages, fp32."""
    f32j, f32t = jnp.float32, torch.float32
    ones = np.ones((128, 128), np.float32)
    seq = 4 * 128
    return {
        "band": (jattn.band_topology(seq, 2, 128, dtype=f32j),
                 tattn.band_topology(seq, 2, 128, dtype=f32t, device="cpu"), seq),
        "random": (jtesting.random_bsr(np.random.default_rng(1), seq, seq, seq * seq // 4, 128),
                   ttesting.random_bsr(np.random.default_rng(1), seq, seq, seq * seq // 4, 128, device="cpu"), seq),
        "causal_window4": (jattn.causal_block_topology(4 * 256, 128, window_blocks=4, dtype=f32j),
                           tattn.causal_block_topology(4 * 256, 128, window_blocks=4, dtype=f32t, device="cpu"),
                           4 * 256),
        # Only block-row 0 attends (to columns 0 and 3).
        "empty_rows": (jtesting.bsr_from_blocks(seq, seq, [0, 0], [0, 3], np.stack([ones] * 2)),
                       ttesting.bsr_from_blocks(seq, seq, [0, 0], [0, 3], np.stack([ones] * 2), device="cpu"), seq),
    }


# name: (topology, op, kwargs); "ring" cases are ring attention, the rest
# sequence-parallel attention. Each JAX ring call compiles for ~15-30 s on
# the CPU, so the topologies are spread over the cases rather than crossed.
ATTN_CASES = {
    "ring_fused_causal_window4": ("causal_window4", "ring", dict(fused=True, causal=True)),
    "ring_fused_empty_rows": ("empty_rows", "ring", dict(fused=True)),
    "ring_unfused_random": ("random", "ring", dict(fused=False)),
    "sharded_fused_kv_replicated_random": ("random", "sharded", dict(fused=True, kv_replicated=True)),
    "sharded_fused_kv_sharded_band": ("band", "sharded", dict(fused=True, kv_replicated=False)),
    "sharded_unfused_kv_replicated_band": ("band", "sharded", dict(fused=False, kv_replicated=True)),
    "sharded_unfused_kv_sharded_causal": ("causal_window4", "sharded",
                                          dict(fused=False, kv_replicated=False, causal=True)),
    "sharded_fused_causal": ("causal_window4", "sharded", dict(fused=True, causal=True)),
}
DH = 64


@pytest.fixture(scope="module")
def attention_runs():
    """{case: (port gloo outputs per rank, JAX output, port case)}, one
    4-rank spawn for every case."""
    mesh = Mesh(np.array(jax.devices()[:S]), ("x",))
    topos = _topologies()
    rng = np.random.default_rng(0)
    qkv = {}
    for name, (_, _, seq) in topos.items():
        qkv[name] = [rng.standard_normal((seq, DH)).astype(np.float32) for _ in range(3)]
    port, want = [], {}
    for case, (tname, op, kw) in ATTN_CASES.items():
        jt, tt, _ = topos[tname]
        q, k, v = qkv[tname]
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        if op == "ring":
            want[case] = jpar.ring_block_sparse_attention(jq, jk, jv, jpar.partition_topology_ring(jt, S), mesh, **kw)
            port.append(("ring_block_sparse_attention", [tq, tk, tv, tpar.partition_topology_ring(tt, S)], kw,
                         (0, 1, 2)))
        else:
            want[case] = jpar.sharded_block_sparse_attention(jq, jk, jv, jpar.partition_topology_rows(jt, S), mesh,
                                                             **kw)
            sharded = (0,) if kw.get("kv_replicated", True) else (0, 1, 2)
            port.append(("sharded_block_sparse_attention", [tq, tk, tv, tpar.partition_topology_rows(tt, S)], kw,
                         sharded))
    ranks = ttesting.run_spmd(ttesting.parallel_cases, S, port)
    return {case: ([r[i] for r in ranks], np.asarray(want[case], np.float32), port[i])
            for i, case in enumerate(ATTN_CASES)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_jax(attention_runs, case):
    got, want, _ = attention_runs[case]
    np.testing.assert_allclose(np.concatenate(got), want, atol=ATOL)


@pytest.mark.parametrize("case", ["ring_fused_empty_rows"])
def test_rows_without_blocks_are_zero(attention_runs, case):
    out = np.concatenate(attention_runs[case][0])
    assert np.all(out[128:] == 0)
    assert np.abs(out[:128]).max() > 0


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_sequential_drive_equals_gloo(attention_runs, case):
    """All S ranks' bodies in turn in one process, each ring step handed the
    band the rotation delivers, give every rank's gloo output bitwise."""
    got, _, (op, args, kw, _) = attention_runs[case]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: CPU matmuls sum in another order on more threads
    try:
        if op == "ring_block_sparse_attention":
            outs = tring.ring_block_sparse_attention_sequential(*args, **kw)
        else:
            kw = {k: v for k, v in kw.items() if k != "kv_replicated"}
            outs = tpattn.sharded_block_sparse_attention_sequential(*args, **kw)
    finally:
        torch.set_num_threads(threads)
    for rank, (seq, gloo) in enumerate(zip(outs, got)):
        np.testing.assert_array_equal(seq.numpy(), gloo, err_msg=f"rank {rank}")
