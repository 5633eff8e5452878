"""The port's block-sparse MoE paths against the JAX package's, in fp32 on
the CPU with numpy-seeded inputs fed to both: ``moe_forward`` with
``impl="bsr"`` (the fused group FFN) and ``"bsr_unfused"``, the dropless
forward with all three impls, its on-device topology and routing glue
(exact integer equality), gradients against ``jax.grad``, and the two
repairs of this slice (``BlockSparseMatrix.create`` hints, the LM's MoE
topology). JAX runs its Pallas FFN, SDD and DSD kernels in interpret
mode; the port runs their plain versions."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.models import moe as jmoe
from sputnik_tpu.models import transformer as jtr
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_ffn, moe_grouped
from sputnik_tpu_torch.models import moe
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.models.convert import load_numpy_
from sputnik_tpu_torch.ops import bsr_softmax, registry
from sputnik_tpu_torch.utils import testing

D = 256


def _moe_pair(d_ff=256, n_experts=4, capacity=128, seed=3, empty_expert=None):
    """JAX parameters and the same values in a port MoE. ``empty_expert``
    gets a router weight that, with ``_tokens``' constant feature, keeps
    every token away from it."""
    kw = dict(d_model=D, d_ff=d_ff, n_experts=n_experts, capacity=capacity)
    jcfg = jmoe.MoEConfig(dtype=jnp.float32, **kw)
    tcfg = moe.MoEConfig(dtype=torch.float32, **kw)
    jparams = jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    if empty_expert is not None:
        jparams = dict(jparams, router=jparams["router"].at[0, empty_expert].set(-100.0))
    tparams = load_numpy_(moe.MoE(tcfg, device="cpu"), jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _tokens(rng, t):
    x = rng.standard_normal((t, D)).astype(np.float32)
    x[:, 0] = 10.0  # a constant feature (see _moe_pair's empty_expert)
    return x


@pytest.mark.parametrize("impl", ["bsr", "bsr_unfused"])
@pytest.mark.parametrize("tokens", [256, 640])  # 640 overflows capacity: drops
def test_moe_forward_bsr_matches_jax(rng, impl, tokens):
    jcfg, jparams, tcfg, tparams = _moe_pair()
    x = rng.standard_normal((tokens, D)).astype(np.float32)
    jy, jaux = jmoe.moe_forward(jparams, jnp.asarray(x), jcfg, jmoe.block_diag_topology(jcfg), impl=impl)
    ty, taux = moe.moe_forward(tparams, torch.from_numpy(x), tcfg, moe.block_diag_topology(tcfg, device="cpu"),
                                impl=impl)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    if tokens == 640:  # dropped tokens give zero rows in both
        assert (np.abs(np.asarray(jy)).max(axis=1) == 0).sum() > 0


def test_moe_forward_checks_impl_and_topology(rng):
    _, _, tcfg, tparams = _moe_pair()
    x = torch.from_numpy(rng.standard_normal((128, D)).astype(np.float32))
    with pytest.raises(ValueError, match="impl"):
        moe.moe_forward(tparams, x, tcfg, impl="dense")
    with pytest.raises(ValueError, match="topology"):
        moe.moe_forward(tparams, x, tcfg, impl="bsr")
    with pytest.raises(ValueError, match="impl"):
        moe.dropless_moe_forward(tparams, x, tcfg, impl="grouped")


@pytest.mark.parametrize("expert_rows", [[2, 0, 1, 3], [0, 0, 5, 0], [1, 1, 1, 1]])
def test_dropless_topology_matches_jax(expert_rows):
    kw = dict(d_model=D, d_ff=256, n_experts=4, capacity=128)
    jcfg, tcfg = jmoe.MoEConfig(dtype=jnp.float32, **kw), moe.MoEConfig(dtype=torch.float32, **kw)
    max_block_rows = 9  # more rows than the groups fill: the tail clamps to E-1
    j = jmoe.dropless_topology(jnp.asarray(expert_rows, jnp.int32), jcfg, max_block_rows)
    t = moe.dropless_topology(torch.tensor(expert_rows), tcfg, max_block_rows)
    for name in ("offsets", "indices", "row_indices"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
        assert getattr(t, name).dtype == torch.int32
    assert (t.shape, t.nnz_blocks, t.max_row_nnz) == (j.shape, j.nnz_blocks, j.max_row_nnz)
    assert t.dtype == torch.float32 and float(t.data.abs().max()) == 0.0


@pytest.mark.parametrize("row_group", [1, 2])
def test_dropless_routing_glue_matches_jax(rng, row_group):
    """max_block_rows, t_pad, expert_rows, group_start, dest, src and the
    fused path's live tiles, against JAX's lines (moe.py:354-391, :298)."""
    _, _, tcfg, _ = _moe_pair()
    t, bs, e = 300, tcfg.block_size, tcfg.n_experts
    logits = rng.standard_normal((t, e)).astype(np.float32)
    logits[:, 1] -= 100.0  # expert 1 gets no token
    # JAX, as dropless_moe_forward writes it.
    max_block_rows = (-(-t // bs) // row_group + e) * row_group
    t_pad = max_block_rows * bs
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, e, dtype=jnp.int32)
    counts = jnp.sum(onehot, axis=0)
    j_rows = -(-counts // bs)
    if row_group > 1:
        j_rows = -(-j_rows // row_group) * row_group
    j_start = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(j_rows[:-1]).astype(jnp.int32)]) * bs
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    j_dest = j_start[expert] + pos
    j_src = jnp.full((t_pad,), t - 1, jnp.int32).at[j_dest].set(jnp.arange(t, dtype=jnp.int32))
    j_live = (jnp.sum(j_rows) * bs) // (row_group * bs)

    mbr, _, prob, t_expert, _, t_rows, dest, src = moe._dropless_route(
        torch.from_numpy(logits), t, tcfg, row_group)
    assert mbr == max_block_rows and src.shape == (t_pad,)
    assert int(t_rows[1]) == 0
    np.testing.assert_array_equal(t_expert.numpy(), np.asarray(expert))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(((torch.cumsum(t_rows, 0) - t_rows) * bs).numpy(), np.asarray(j_start))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(j_dest))
    np.testing.assert_array_equal(src.numpy(), np.asarray(j_src))
    assert int((t_rows.sum() * bs) // (row_group * bs)) == int(j_live)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jnp.max(probs, axis=-1)), rtol=1e-6)


@pytest.mark.parametrize("row_group", [1, 2])
@pytest.mark.parametrize("impl", ["ragged", "bsr", "bsr_fused"])
def test_dropless_moe_forward_matches_jax(rng, impl, row_group):
    """640 tokens over 4 experts, expert 2 routed no token."""
    jcfg, jparams, tcfg, tparams = _moe_pair(empty_expert=2)
    x = _tokens(rng, 640)
    jy, jaux = jmoe.dropless_moe_forward(jparams, jnp.asarray(x), jcfg, impl=impl, row_group=row_group)
    ty, taux = moe.dropless_moe_forward(tparams, torch.from_numpy(x), tcfg, impl=impl, row_group=row_group)
    logits = x @ np.asarray(jparams["router"])
    assert 2 not in logits.argmax(axis=1)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)


def _grads(path, impl):
    """(loss, {router, w1, w2, x} gradients) of sum(y^2) * 1e-3 + 0.01 * aux
    in both packages, 150 tokens over 2 experts."""
    jcfg, jparams, tcfg, tparams = _moe_pair(d_ff=128, n_experts=2)
    x = np.random.default_rng(7).standard_normal((150, D)).astype(np.float32)
    if path == "capacity":
        jtopo, ttopo = jmoe.block_diag_topology(jcfg), moe.block_diag_topology(tcfg, device="cpu")
        jfwd = lambda p, x_: jmoe.moe_forward(p, x_, jcfg, jtopo, impl=impl)  # noqa: E731
        tfwd = lambda p, x_: moe.moe_forward(p, x_, tcfg, ttopo, impl=impl)  # noqa: E731
    else:
        jfwd = lambda p, x_: jmoe.dropless_moe_forward(p, x_, jcfg, impl=impl)  # noqa: E731
        tfwd = lambda p, x_: moe.dropless_moe_forward(p, x_, tcfg, impl=impl)  # noqa: E731

    def jloss(p, x_):
        y, aux = jfwd(p, x_)
        return jnp.sum(y ** 2) * 1e-3 + 0.01 * aux

    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tfwd(tparams, tx)
    tl = torch.sum(y ** 2) * 1e-3 + 0.01 * aux
    tl.backward()
    want = {k: np.asarray(v) for k, v in jg.items()} | {"x": np.asarray(jgx)}
    got = {n: p.grad.numpy() for n, p in tparams.named_parameters()} | {"x": tx.grad.numpy()}
    return (float(tl.detach()), got), (float(jl), want)


@pytest.mark.parametrize("path,impl", [("capacity", "bsr"), ("dropless", "bsr"), ("dropless", "bsr_fused")])
def test_moe_grads_match_jax(path, impl):
    """Every parameter's gradient and dx within 1e-3 * max|g| + 1e-6. For
    the dropless paths a leak through the padding slots (clamped onto the
    last token) would show in dx of that token."""
    (tl, got), (jl, want) = _grads(path, impl)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(got) == set(want)
    for name, g in want.items():
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(got[name], g, atol=1e-3 * np.abs(g).max() + 1e-6, rtol=0, err_msg=name)


def test_create_hints_from_host_metadata():
    """numpy and CPU-tensor metadata give the hints create always computed;
    hints the caller passes are kept as given; the BSR softmax reads the
    offsets and needs no hint."""
    offsets = np.array([0, 2, 2, 5], np.int32)  # rows of 2, 0 and 3 blocks
    indices = np.array([0, 3, 0, 1, 3], np.int32)  # columns hit 2, 1, 0, 2 times
    data = torch.zeros(5, 128, 128)
    shape = (3 * 128, 4 * 128)
    for off, idx in ((offsets, indices), (torch.from_numpy(offsets), torch.from_numpy(indices))):
        m = BlockSparseMatrix.create(data, off, idx, shape)
        assert (m.max_row_nnz, m.min_row_nnz, m.max_col_nnz, m.min_col_nnz) == (3, 0, 2, 0)
    m = BlockSparseMatrix.create(data, offsets, indices, shape, max_row_nnz=7, max_col_nnz=9)
    assert (m.max_row_nnz, m.min_row_nnz, m.max_col_nnz, m.min_col_nnz) == (7, 0, 9, 0)
    # The softmax gives the same probabilities without the hint.
    m = m.with_data(torch.randn(5, 128, 128, generator=torch.Generator().manual_seed(0)))
    want = bsr_softmax(m, causal=True).data
    torch.testing.assert_close(bsr_softmax(dataclasses.replace(m, max_row_nnz=None), causal=True).data, want,
                               atol=0, rtol=0)


def test_lm_topologies_carry_the_moe_topology():
    """The LM's second topology is JAX's block-diagonal MoE topology, and
    the fused FFN plans it without reading its metadata again."""
    kw = dict(d_model=256, n_heads=2, seq_len=512, n_experts=4, d_ff=256, n_layers=1, vocab=256)
    _, j = jtr.lm_topologies(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    _, t = tr.lm_topologies(tr.TransformerConfig(dtype=torch.float32, **kw), device="cpu")
    for name in ("offsets", "indices", "row_indices"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.shape == j.shape and t.nnz_blocks == j.nnz_blocks
    assert bsr_ffn._entry(t) is not None and bsr_ffn.plan_group_ffn(t)[1] == 1


# --------------------------------------- the grouped FFN's registry op --
def _parent_grouped(params, x, cfg):
    """``moe_forward(impl="grouped")`` as it read before the op
    ``moe_grouped_ffn``: fp32 copies of the operands, two fp32 ``bmm``."""
    slot, keep, prob, aux = moe._route(moe.router_logits(params, x, cfg), cfg)
    slot_or_drop = torch.where(keep, slot, cfg.padded_tokens)
    x_perm = torch.zeros((cfg.padded_tokens + 1, x.shape[1]), dtype=cfg.dtype)
    x_perm[slot_or_drop] = x.to(cfg.dtype)
    x_perm = x_perm[: cfg.padded_tokens]
    e, c, d, f = cfg.n_experts, cfg.capacity, cfg.d_model, cfg.d_ff
    xg = x_perm.reshape(e, c, d).float()
    w1 = params.w1.reshape(d, e, f).permute(1, 0, 2).float()
    w2 = params.w2.reshape(e, f, d).float()
    h = torch.nn.functional.gelu(torch.bmm(xg, w1), approximate="tanh").to(cfg.dtype)
    y = torch.bmm(h.float(), w2).reshape(e * c, d)[slot]
    return (y * (prob * keep.float())[:, None]).to(x.dtype), aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [256, 640])  # 640 overflows capacity: drops
def test_grouped_route_matches_parent_bitwise(rng, dtype, tokens):
    """On the CPU the registry op takes the plain variant, and y, the aux
    loss and every gradient equal the former inline fp32 path bit for bit;
    expert 1 gets no token."""
    _, _, tcfg, tparams = _moe_pair(empty_expert=1)
    cfg = dataclasses.replace(tcfg, dtype=dtype)
    params = moe.MoE(cfg, device="cpu")
    params.load_state_dict({k: v.to(params.state_dict()[k].dtype) for k, v in tparams.state_dict().items()})
    x = torch.from_numpy(_tokens(rng, tokens))
    outs = []
    for fn in (lambda p, xs: moe.moe_forward(p, xs, cfg), lambda p, xs: _parent_grouped(p, xs, cfg)):
        params.zero_grad(set_to_none=True)
        xs = x.clone().requires_grad_()
        y, aux = fn(params, xs)
        (torch.mean(y.float() ** 2) + 0.01 * aux).backward()
        outs.append([y.detach(), aux.detach(), xs.grad] + [p.grad for p in params.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    if tokens == 640:
        assert int(outs[0][0].abs().amax(-1).eq(0).sum()) >= tokens - 3 * 128  # three experts' capacity


def _fake_cuda(shape, dtype=torch.bfloat16):
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=torch.Size(shape), ndim=len(shape))


def test_grouped_ffn_routes_plain_problems_to_the_plain_variant():
    """CPU problems and, under forced_variant, every problem take
    ``torch_reference``; ``cuda_grouped``'s predicate takes bf16 card
    problems with d and F multiples of 128 and C of 64 only (fake CUDA
    operands: this machine may have no card)."""
    e, c, d, f = 4, 128, 256, 256
    cpu = [torch.zeros(e * c, d), torch.zeros(d, e * f), torch.zeros(e * f, d)]
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in cpu]
        assert registry.dispatch_name("moe_grouped_ffn", *args, e) == "torch_reference"
    card = lambda c_, d_, f_, dtype=torch.bfloat16: [  # noqa: E731
        _fake_cuda((e * c_, d_), dtype), _fake_cuda((d_, e * f_), dtype), _fake_cuda((e * f_, d_), dtype)]
    assert registry.dispatch_name("moe_grouped_ffn", *card(c, d, f), e) == "cuda_grouped"
    with registry.forced_variant("torch_reference"):
        assert registry.dispatch_name("moe_grouped_ffn", *card(c, d, f), e) == "torch_reference"
    for args in (card(c, d, f, torch.float32), card(96, d, f), card(c, 192, f), card(c, d, 320)):
        assert registry.dispatch_name("moe_grouped_ffn", *args, e) == "torch_reference"
    mixed = card(c, d, f)
    mixed[1] = _fake_cuda((d, e * f), torch.float32)
    assert registry.dispatch_name("moe_grouped_ffn", *mixed, e) == "torch_reference"


@pytest.mark.parametrize("e,c,d,f", [(4, 64, 128, 256), (3, 128, 256, 128)])
def test_grouped_ffn_launches_emulated_match_plain(rng, e, c, d, f):
    """The kernels' launches as ``gemm_reference`` reads them (operands at
    their per-expert steps, the three-term split, the four epilogues),
    through the autograd Function, against autograd of the plain fp32
    ``bmm`` path, with the limits of ``testing.moe_grouped_errors``: y
    within 2^-8 of its max, the bf16 gradients within 2^-7 of theirs (h and
    dh are rounded to bf16 on both sides, and a value at a rounding boundary
    may round either way)."""
    x = torch.from_numpy(rng.standard_normal((e * c, d)).astype(np.float32)).to(torch.bfloat16)
    x[c // 2:c] = 0  # half of expert 0's slots empty
    w1 = torch.from_numpy(rng.standard_normal((d, e * f)).astype(np.float32) * d ** -0.5).to(torch.bfloat16)
    w2 = torch.from_numpy(rng.standard_normal((e * f, d)).astype(np.float32) * f ** -0.5).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((e * c, d)).astype(np.float32))
    outs = []
    for fn in (lambda *a: moe_grouped.GroupedFfn.apply(*a, e, True, moe_grouped.gemm_reference,
                                                       moe_grouped.split3_reference),
               lambda *a: moe_grouped.grouped_ffn_reference(*a, e)):
        leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
        y = fn(*leaves)
        y.backward(g)
        outs.append([y.detach()] + [t.grad for t in leaves])
    for got, want in zip(*outs):
        assert got.dtype == want.dtype
        assert testing.rel_max_error(got, want) <= (2 ** -8 if got.dtype == torch.float32 else 2 ** -7)


def test_grouped_split_is_exact(rng):
    g = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    # Exact from 2^-110 (the third term still a normal number) to bf16's largest finite value.
    g = torch.cat([g * 1e-25, g, g * 1e30, torch.tensor([0.0, -0.0, 1.0, 2.0 ** -110, 3.0e38])])
    parts = moe_grouped.split3_reference(g)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3,) + g.shape
    assert torch.equal(parts[0].float() + parts[1].float() + parts[2].float(), g)


def test_grouped_plan_and_checks():
    """``plan`` at the benchmark's per-layer shapes (E 64, C 128) on the
    H100 SXM's 132 SMs: 128 x 256 tiles, but 64 x 256 where 128 x 256 tiles
    would leave most of a last wave idle; ``gemm`` refuses CPU tensors."""
    assert moe_grouped.plan(128, 3072, 64, 132) == (128, 256)
    assert moe_grouped.plan(128, 4096, 64, 132) == (128, 256)
    assert moe_grouped.plan(3072, 768, 64, 132) == (128, 256)
    assert moe_grouped.plan(4096, 1024, 64, 132) == (128, 256)  # 8192 tiles: the wave's tail is noise
    assert moe_grouped.plan(128, 768, 64, 132) == (64, 256)  # 192 tiles of 128 x 256: 1.45 waves
    assert moe_grouped.plan(128, 1024, 64, 132) == (128, 256)  # 256 tiles: 1.94 waves
    with pytest.raises(ValueError, match="multiple"):
        moe_grouped.plan(96, 256, 4, 132)
    x, w1, w2 = torch.zeros(256, 128, dtype=torch.bfloat16), torch.zeros(128, 512, dtype=torch.bfloat16), \
        torch.zeros(512, 128, dtype=torch.bfloat16)
    h, y = torch.zeros(256, 256, dtype=torch.bfloat16), torch.zeros(256, 128)
    with pytest.raises(ValueError, match="CUDA"):
        moe_grouped.gemm(moe_grouped.forward_gemms(x, w1, w2, 2, h, y)[0])


@pytest.mark.parametrize("tokens", [256, 640])  # 640 overflows capacity: drops
def test_grouped_kernel_route_bf16_matches_jax(rng, monkeypatch, tokens):
    """The bf16 configuration the kernels serve, on the CPU: ``moe_forward``
    through ``cuda_grouped``'s autograd Function with every launch emulated
    by ``gemm_reference`` and the split by ``split3_reference`` (bf16
    operands, fp32 products and accumulation, gelu on the fp32
    pre-activation, bf16 h, the fp32 cotangents as three exact bf16 terms,
    gradients rounded to bf16), against ``jax.vjp`` of the JAX package's
    ``moe_forward(impl="grouped")`` (its two einsums with
    ``preferred_element_type=float32``) on the same bf16 inputs and
    cotangent: y within 2^-8 of its max and every gradient within 2^-7 of
    its max, the limits of the card tests (h and dh are rounded to bf16 on
    both sides, and a value at a rounding boundary may round either way).
    Besides, each gradient's mean |diff| within 2^-12 of its mean |value|:
    with the split exact, both sides' products agree up to fp32 summation
    order and only the few elements at a rounding boundary differ (measured
    at most 5.6e-6), where a split that kept only the first term misses by
    1.6e-3 to 3.0e-3. Expert 1 gets no token."""
    jcfg, jparams, tcfg, _ = _moe_pair(empty_expert=1)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    jparams = dict(jparams, w1=jparams["w1"].astype(jnp.bfloat16), w2=jparams["w2"].astype(jnp.bfloat16))
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = moe.MoE(cfg, device="cpu")
    params.load_state_dict({k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(params.state_dict()[k].dtype)
                            for k, v in jparams.items()})
    x = _tokens(rng, tokens)
    g = rng.standard_normal((tokens, D)).astype(np.float32)
    jx, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    jy, vjp = jax.vjp(lambda p, xs: jmoe.moe_forward(p, xs, jcfg, None, impl="grouped")[0], jparams, jx)
    jgrads, jgx = vjp(jg)

    monkeypatch.setattr(moe_grouped, "gemm", moe_grouped.gemm_reference)
    monkeypatch.setattr(moe_grouped, "split3", moe_grouped.split3_reference)
    xs = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    with registry.forced_variant("cuda_grouped"):
        y, _ = moe.moe_forward(params, xs, cfg)
    y.backward(torch.from_numpy(g).to(torch.bfloat16))

    def to_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32)))

    assert y.dtype == torch.bfloat16 and testing.rel_max_error(y.detach(), to_torch(jy)) <= 2 ** -8
    grads = {"x": (xs.grad, jgx), **{n: (p.grad, jgrads[n]) for n, p in params.named_parameters()}}
    for name, (got, want) in grads.items():
        assert got.dtype == params.state_dict().get(name, xs).dtype, name
        assert testing.rel_max_error(got, to_torch(want)) <= 2 ** -7, name
        diff = (got.float() - to_torch(want)).abs().mean() / to_torch(want).abs().mean()
        assert float(diff) <= 2 ** -12, (name, float(diff))
    if tokens == 640:
        assert int(y.detach().abs().amax(-1).eq(0).sum()) >= tokens - 3 * 128  # three experts' capacity
