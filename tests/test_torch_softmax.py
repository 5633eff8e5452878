"""The port's BSR softmax (both variants, and its gradient) and fused SDD +
softmax against the JAX package, in fp32 on the CPU.

The same numpy scores go through ``sputnik_tpu.ops.bsr_softmax`` (its jnp
chain, and ``variant="pallas"``: the two Pallas kernels in interpret mode
with their custom VJP) and the port's ``ops.bsr_softmax``: ``"jnp"`` (the
torch chain), ``"pallas"`` (the kernels' plain versions on CPU tensors,
inside the same autograd Function the card runs) and the default (the
chain on the CPU). Softmax values and gradients agree within 1e-5
(ROADMAP.md section 3). The softmax needs no ``max_row_nnz`` hint on any
route: a topology re-created without one, as metadata built on the card
has none, gives the same result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import ops as jops
from sputnik_tpu.models import attention as jattn
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import ops
from sputnik_tpu_torch.kernels import bsr_softmax as bsm
from sputnik_tpu_torch.models import attention
from sputnik_tpu_torch.utils import testing

BS = 128
TOL = 1e-5


def _topologies(kind):
    """(jax topology, port topology) of zero blocks."""
    if kind == "causal_band":
        return (jattn.causal_block_topology(512, BS, window_blocks=2, dtype=jnp.float32),
                attention.causal_block_topology(512, BS, window_blocks=2, dtype=torch.float32, device="cpu"))
    # Unordered columns within rows, an empty block-row (1) and a block above
    # the diagonal in the first row (fully masked there under causal).
    args = (512, 512, [0, 0, 2, 2, 2, 3], [1, 0, 2, 0, 1, 3], np.zeros((6, BS, BS), np.float32))
    return jtesting.bsr_from_blocks(*args), testing.bsr_from_blocks(*args, device="cpu")


def _no_hint(m):
    """``m`` as a topology built on the card holds it: no nnz hints, no host
    copies of the metadata."""
    return dataclasses.replace(m, max_row_nnz=None, max_col_nnz=None, host_offsets=None, host_indices=None)


@pytest.mark.parametrize("variant", [None, "jnp", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["causal_band", "irregular"])
def test_bsr_softmax_matches_jax(kind, causal, variant):
    jtopo, ttopo = _topologies(kind)
    data = np.random.default_rng(1).standard_normal(tuple(ttopo.data.shape)).astype(np.float32) * 4
    want = np.asarray(jops.bsr_softmax(jtopo.with_data(jnp.asarray(data)), scale=0.7, causal=causal).data)
    for topo in (ttopo, _no_hint(ttopo)):
        got = ops.bsr_softmax(topo.with_data(torch.from_numpy(data)), scale=0.7, causal=causal, variant=variant)
        np.testing.assert_allclose(got.data.numpy(), want, atol=TOL)
    if kind == "irregular" and causal:  # block (0, 1) lies above the diagonal
        assert not got.data[0].any()


@pytest.mark.parametrize("variant", ["jnp", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
def test_bsr_softmax_grad_matches_jax_pallas_vjp(causal, variant):
    """The gradient of sum(p * w) against jax.grad through JAX's
    variant="pallas" (its custom VJP over the interpret-mode kernels)."""
    jtopo, ttopo = _topologies("irregular")
    rng = np.random.default_rng(2)
    data, w = (rng.standard_normal(tuple(ttopo.data.shape)).astype(np.float32) for _ in range(2))

    def jloss(x):
        return jnp.sum(jops.bsr_softmax(jtopo.with_data(x), scale=0.5, causal=causal, variant="pallas").data * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    x = torch.from_numpy(data).requires_grad_()
    p = ops.bsr_softmax(_no_hint(ttopo).with_data(x), scale=0.5, causal=causal, variant=variant)
    (p.data * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=TOL)


def test_batched_softmax_is_per_entry():
    """A leading batch axis (heads) normalizes each entry on its own, on
    both variants, as one call per entry would."""
    _, ttopo = _topologies("causal_band")
    data = torch.from_numpy(np.random.default_rng(3).standard_normal((3,) + tuple(ttopo.data.shape))
                            .astype(np.float32))
    for variant in ("jnp", "pallas"):
        got = ops.bsr_softmax(ttopo.with_data(data), scale=0.3, causal=True, variant=variant).data
        for i in range(3):
            one = ops.bsr_softmax(ttopo.with_data(data[i]), scale=0.3, causal=True, variant=variant).data
            torch.testing.assert_close(got[i], one, atol=0, rtol=0)


def test_stats_plain_version_and_empty_rows():
    """The stats pass's plain version: m and l of every element-row against
    dense masked math; an empty block-row gives the empty-row values
    (m = -1e30, l = 0), a fully masked row l = 0 and zero probabilities."""
    _, ttopo = _topologies("irregular")
    data = torch.from_numpy(np.random.default_rng(4).standard_normal(tuple(ttopo.data.shape)).astype(np.float32))
    m, l = bsm.stats_reference(data, _no_hint(ttopo), scale=0.5, causal=True)
    dense = ttopo.with_data(data * 0.5).to_dense()
    i, j = np.arange(512)[:, None], np.arange(512)[None, :]
    mask = _block_mask(ttopo).repeat_interleave(BS, 0).repeat_interleave(BS, 1) & torch.from_numpy(j <= i)
    s = dense.masked_fill(~mask, float("-inf"))
    live = mask.any(dim=1)
    want_m = s.amax(dim=1)
    torch.testing.assert_close(m[live], want_m[live], atol=1e-6, rtol=0)
    torch.testing.assert_close(l[live], torch.exp(s - want_m[:, None]).sum(dim=1)[live], atol=1e-5, rtol=1e-6)
    assert (m[~live] == bsm.NEG_INF).all() and (l[~live] == 0).all()
    assert (~live[128:256]).all()  # block-row 1 has no block
    p = bsm.normalize_reference(data, m, l, ttopo, scale=0.5, causal=True, out_dtype=torch.float32)
    assert not p[0].any()  # block (0, 1) is above the diagonal


def _block_mask(topo):
    mask = torch.zeros((topo.block_rows, topo.block_cols), dtype=torch.bool)
    mask[topo.row_indices.long(), topo.indices.long()] = True
    return mask


@pytest.mark.parametrize("scale", [None, 0.125])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", [64, 128])
def test_sdd_softmax_matches_jax(dh, causal, scale):
    """ops.sdd_softmax against sputnik_tpu.ops.sdd_softmax (its fused Pallas
    score kernel in interpret mode and its epilogue); scale=None applies no
    scaling in both. Also equal to the unfused SDD -> softmax."""
    jtopo, ttopo = _topologies("causal_band")
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((512, dh)).astype(np.float32) * dh ** -0.25 for _ in range(2))
    want = jops.sdd_softmax(jnp.asarray(q), jnp.asarray(k), jtopo, scale=scale, causal=causal)
    got = ops.sdd_softmax(torch.from_numpy(q), torch.from_numpy(k), ttopo, scale=scale, causal=causal)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), atol=TOL)
    chain = ops.bsr_softmax(ops.sdd(torch.from_numpy(q), torch.from_numpy(k), ttopo, transpose_b=True),
                            scale=scale, causal=causal)
    np.testing.assert_allclose(got.data.numpy(), chain.data.numpy(), atol=TOL)
    batched = ops.sdd_softmax(torch.from_numpy(np.stack([q, q])), torch.from_numpy(np.stack([k, k])), ttopo,
                              scale=scale, causal=causal)
    torch.testing.assert_close(batched.data[1], got.data, atol=0, rtol=0)


def test_variants_and_checks():
    """JAX's variant names, the empty topology, the registry's routing of
    the passes, and the kernel wrappers refusing CPU tensors."""
    _, ttopo = _topologies("causal_band")
    with pytest.raises(ValueError, match="'pallas' or 'jnp'"):
        ops.bsr_softmax(ttopo, variant="cuda")
    empty = testing.bsr_from_blocks(256, 256, [], [], np.zeros((0, BS, BS), np.float32), device="cpu")
    assert ops.bsr_softmax(empty, variant="pallas") is empty
    data = ttopo.data
    assert ops.registry.dispatch_name("bsr_softmax_stats", data, ttopo, scale=1.0, causal=True) \
        == "torch_reference"
    with ops.registry.forced_variant("cuda_softmax"):
        assert ops.registry.dispatch_name("bsr_softmax_normalize", data, data, data, ttopo) == "cuda_softmax"
    m = torch.zeros(1, 512)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bsm.launch_stats(data, ttopo, m, m.clone(), scale=1.0, causal=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bsm.launch_scores(torch.zeros(1, 512, 64), torch.zeros(1, 512, 64), ttopo, torch.zeros(1, 1), m, m,
                          scale=1.0, causal=True)
