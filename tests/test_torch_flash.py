"""The port's ``flash_mha`` (forward and the dQ / dK / dV backward) against
the JAX package's ``flash_mha``, in fp32 on the CPU.

The same numpy q, k, v and cotangent go through both. JAX runs its Pallas
kernels in interpret mode; on CPU tensors the port's autograd Function runs
the three plain versions (dense masked fp32 math) inside its own forward
and backward, so this holds the port's backward formula (dvec, the dQ and
dK/dV split) to JAX's. Bounds are JAX's own for flash_mha against the
unfused chain (tests/test_flash_attention.py): 5e-3 forward, 5e-2
gradients; the measured maxima are about 1e-6 (see PERF.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.kernels.flash_mha import flash_mha as jflash_mha
from sputnik_tpu.models import attention as jattn
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import ops
from sputnik_tpu_torch.kernels import flash_mha as fm
from sputnik_tpu_torch.models import attention
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing

BS = 128
ONES = np.ones((3, BS, BS), np.float32)


def _topologies(kind, rng):
    """(jax topology, port topology, T, Tk, causal)."""
    if kind == "causal_band":
        t = 512
        return (jattn.causal_block_topology(t, BS, window_blocks=2, dtype=jnp.float32),
                attention.causal_block_topology(t, BS, window_blocks=2, dtype=torch.float32), t, t, True)
    if kind == "random":
        seed = int(rng.integers(1 << 30))
        jm = jtesting.random_bsr(np.random.default_rng(seed), 512, 512, 512 * 512 // 3, BS, unordered=True)
        tm = testing.random_bsr(np.random.default_rng(seed), 512, 512, 512 * 512 // 3, BS, unordered=True)
        return jm, tm, 512, 512, False
    if kind == "empty_row_col":  # tests/test_flash_attention.py:131-136
        args = (384, 512, [0, 0, 2], [3, 0, 0], ONES)
        return jtesting.bsr_from_blocks(*args), testing.bsr_from_blocks(*args), 384, 512, False
    # rectangular K/V: more keys than queries
    seed = int(rng.integers(1 << 30))
    jm = jtesting.random_bsr(np.random.default_rng(seed), 256, 512, 256 * 512 // 3, BS)
    tm = testing.random_bsr(np.random.default_rng(seed), 256, 512, 256 * 512 // 3, BS)
    return jm, tm, 256, 512, False


@pytest.mark.parametrize("kind", ["causal_band", "random", "empty_row_col", "rectangular"])
def test_flash_mha_matches_jax(kind):
    rng = np.random.default_rng(7)
    jtopo, ttopo, t, tk, causal = _topologies(kind, rng)
    h, dh = 2, 128
    q, g = (rng.standard_normal((h, t, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((h, tk, dh)).astype(np.float32) for _ in range(2))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    def jloss(q_, k_, v_):
        out = jflash_mha(q_, k_, v_, jtopo, causal=causal)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    tq, tk_, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fm.flash_mha(tq, tk_, tv, ttopo, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    errs = [float(np.abs(out.detach().numpy() - np.asarray(jout)).max())]
    errs += [float(np.abs(x.grad.numpy() - np.asarray(y)).max()) for x, y in zip((tq, tk_, tv), jgrads)]
    print(f"{kind}: max |port - jax| out {errs[0]:.3e}, dq {errs[1]:.3e}, dk {errs[2]:.3e}, dv {errs[3]:.3e}")
    assert errs[0] <= 5e-3 and max(errs[1:]) <= 5e-2, errs
    if kind == "empty_row_col":  # row 1 has no block; key columns 1 and 2 none
        assert not out[:, 128:256].detach().any() and not tq.grad[:, 128:256].any()
        assert not tk_.grad[:, 128:384].any() and not tv.grad[:, 128:384].any()
        assert tk_.grad[:, :128].abs().max() > 0


def test_fully_masked_causal_row_is_zero():
    """A row whose only block lies above the diagonal comes out zero, with
    zero gradient, not NaN (tests/test_flash_attention.py:79)."""
    topo = testing.bsr_from_blocks(384, 384, [0, 1, 1, 2], [2, 0, 1, 2], np.ones((4, BS, BS), np.float32))
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 384, 128)).astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = fm.flash_mha(q, k, v, topo, causal=True)
    out.sum().backward()
    assert not out[0, :128].detach().any() and torch.isfinite(out).all()
    assert not q.grad[0, :128].any() and all(torch.isfinite(x.grad).all() for x in (q, k, v))
    _, lse = fm.fwd_reference(q.detach(), k.detach(), v.detach(), topo, causal=True, scale=0.1)
    assert (lse[0, :128] == fm.POS_BIG).all() and (lse[0, 128:] < 1e29).all()


def test_single_head_fused_attention_matches_jax():
    """block_sparse_attention(fused=True) runs flash_mha with one head, as
    the JAX package's route does."""
    rng = np.random.default_rng(9)
    jtopo, ttopo, t, _, _ = _topologies("causal_band", rng)
    q, k, v = (rng.standard_normal((t, 128)).astype(np.float32) for _ in range(3))
    want = jattn.block_sparse_attention(*(jnp.asarray(x) for x in (q, k, v)), jtopo, causal=True, fused=True)
    got = attention.block_sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)), ttopo, causal=True,
                                           fused=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)
    unfused = attention.block_sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)), ttopo, causal=True)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=1e-5)


def test_checks_and_dispatch():
    """JAX's argument checks, the empty topology, the registry's routing,
    and the kernel wrappers refusing CPU tensors."""
    topo = attention.causal_block_topology(384, BS, window_blocks=2, dtype=torch.float32)
    q = torch.zeros(1, 384, 128)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="rows_per_step"):
            fm.flash_mha(q, q, q, topo, rows_per_step=bad)
    with pytest.raises(ValueError, match="divisible"):
        fm.flash_mha(q, q, q, topo, rows_per_step=2)  # 3 query block-rows
    with pytest.raises(ValueError, match="group"):
        fm.flash_mha(q, q, q, topo, group=0)
    empty = testing.bsr_from_blocks(384, 384, [], [], np.zeros((0, BS, BS), np.float32))
    assert not fm.flash_mha(q + 1, q, q, empty).any()
    assert registry.dispatch_name("flash_mha", q, q, q, topo) == "torch_reference"
    with registry.forced_variant("cuda_flash"):
        assert registry.dispatch_name("flash_mha", q, q, q, topo) == "cuda_flash"
    assert ops.flash_mha is fm.flash_mha
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fm.launch_fwd(q, q, q, topo, q.clone(), torch.zeros(1, 384), causal=True, scale=0.1)
