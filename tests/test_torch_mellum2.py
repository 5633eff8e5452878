"""Mellum2's layer pattern at a small size on the CPU: one whole period of
3 sliding and 1 full layers, GQA 2:1, a 256-token window on 512-token
prompts, top-4 of 16 SwiGLU experts, seeded weights
(``benchmark/weights_mellum2.py``) in fp32, the port against the plain
reference ``benchmark/reference/mellum2.py``: the forward's logits,
prefill and decode through the caches, the window's edge, YaRN's
frequencies and factor, the top-k renormalisation, the ragged launches'
descriptions, the windowed softmax, the benchmark cell run through the
harness; the route of the unfused attention chain (the registry op
bsr_attention's predicate, and on the CPU the chain with its dispatch
counts); and the MegaBlocks defaults building the leaves they built
before."""

import dataclasses
import json
import math
import shutil
import time

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, weights_mellum2
from benchmark.drivers import serve_mellum2
from benchmark.reference import mellum2 as ref
from benchmark.tests import tiny
from sputnik_tpu_torch import ops
from sputnik_tpu_torch.kernels import bsr_softmax as bsm
from sputnik_tpu_torch.kernels import flash_mha as fm
from sputnik_tpu_torch.kernels import moe_grouped as mgk
from sputnik_tpu_torch.models import attention, moe
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.ops import softmax as ops_softmax
from sputnik_tpu_torch.utils import tracing

SEED = 2**31 + 1818
FULL = json.loads((tiny.BENCH / "configs" / "mellum2-12b-a2.5b.json").read_text())
CFG = dict(FULL, hidden_size=128, num_attention_heads=4, num_key_value_heads=2, head_dim=32, num_experts=16,
           moe_intermediate_size=128, num_experts_per_tok=4, num_hidden_layers=4, vocab_size=512,
           sliding_window=256, layer_types=["sliding_attention"] * 3 + ["full_attention"], dtype="float32")


@pytest.fixture(scope="module")
def port():
    return serve_mellum2.build(CFG, SEED, "cpu")


def load(name):
    return weights_mellum2.draw(CFG, SEED, name, "cpu")


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_forward_logits_match_the_reference(port):
    tcfg, model = port
    tokens = torch.randint(0, 512, (512,), generator=torch.Generator().manual_seed(1))
    logits, _ = tr.lm_forward(model, tokens, dataclasses.replace(tcfg, seq_len=512))
    want = ref.served_logits(load, CFG, [tokens], [1])[0]  # rows 0 .. T - 2
    assert rel(logits[:-1].detach(), want) < 1e-4


def test_prefill_then_decode_match_the_reference(port):
    tcfg, model = port
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, 512, (512,), generator=g)
    served = torch.randint(0, 512, (6,), generator=g)
    caches, logits = tr.lm_prefill(model, prompt, tcfg, 640)
    assert tuple(caches[0]["k"].shape) == (2, 640, 32)  # the KV heads, not the query heads
    rows = [logits]
    for i in range(len(served) - 1):
        lg, caches = tr.lm_decode_step(model, served[i], caches, 512 + i, tcfg)
        rows.append(lg)
    want = ref.served_logits(load, CFG, [torch.cat([prompt, served])], [512])[0]
    assert rel(torch.stack(rows), want) < 1e-4


def test_window_edge_prefill_and_decode():
    """With q = 0 every allowed key weighs the same, so the output is the
    mean of the allowed keys' values: v_j = j gives i - 127.5 for a
    256-token window once i >= 255 (key i - 256 out, i - 255 in)."""
    t, w = 512, 256
    topo = attention.causal_block_topology(t, window_blocks=w // 128 + 1, dtype=torch.float32, device="cpu")
    q = torch.zeros((1, t, 32))
    v = torch.arange(t, dtype=torch.float32)[None, :, None].expand(1, t, 32).contiguous()
    o = attention.multihead_block_sparse_attention(q, q.clone(), v, topo, causal=True, window=w)[0, :, 0]
    i = torch.arange(t, dtype=torch.float32)
    want = torch.where(i >= w - 1, i - (w - 1) / 2, i / 2)
    assert torch.allclose(o, want, atol=1e-4)
    for pos in (255, 256, 300, 383, 384, 511):
        od = attention.decode_window_attention(torch.zeros((2, 32)), torch.zeros((1, t, 32)), v, pos, window=w)
        assert torch.allclose(od, torch.full_like(od, float(want[pos])), atol=1e-4), pos


@pytest.mark.parametrize("window", [256, None, "tensor"])
def test_decode_attention_with_the_position_on_the_device(window):
    """A position held in a 0-d tensor (a step captured in a CUDA graph)
    attends the keys the host position attends: the window's (also as a
    tensor), or every key up to it; random q, k, v, GQA 2:1."""
    g = torch.Generator().manual_seed(5)
    t = 512
    k, v = torch.randn((2, t, 32), generator=g), torch.randn((2, t, 32), generator=g)
    for pos in (0, 100, 254, 255, 256, 300, 511):
        q = torch.randn((4, 32), generator=g)
        want = attention.decode_window_attention(q, k, v, pos, window=256 if window else None)
        w = torch.tensor(256) if window == "tensor" else window
        got = attention.decode_window_attention(q, k, v, torch.tensor(pos), window=w)
        assert torch.allclose(got, want, atol=1e-6), (pos, window)


def test_decode_steps_with_the_position_on_the_device_match_the_reference(port):
    """Two prompts prefilled, their caches stacked as a DecodeGraph holds
    them, then lm_decode_step with the position in a 0-d tensor (what the
    graph captures) against the reference's full forward."""
    tcfg, model = port
    g = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, 512, (2, 512), generator=g)
    served = torch.randint(0, 512, (2, 5), generator=g)
    per_seq = [tr.lm_prefill(model, p, tcfg, 640) for p in prompts]
    caches = [{n: torch.stack([c[layer][n] for c, _ in per_seq]) for n in ("k", "v")} for layer in range(4)]
    rows = [torch.stack([lg for _, lg in per_seq])]
    for i in range(served.shape[1] - 1):
        lg, caches = tr.lm_decode_step(model, served[:, i], caches, torch.tensor(512 + i), tcfg)
        rows.append(lg)
    want = ref.served_logits(load, CFG, list(torch.cat([prompts, served], dim=1)), [512, 512])
    for b in range(2):
        assert rel(torch.stack([r[b] for r in rows]), want[b]) < 1e-4
    assert not tr.graphable(tcfg, torch.device("cpu"))


def test_windowed_softmax_plain_versions_agree():
    topo = attention.causal_block_topology(512, window_blocks=3, dtype=torch.float32, device="cpu")
    data = torch.randn((2, topo.nnz_blocks, 128, 128), generator=torch.Generator().manual_seed(3))
    m, l = bsm.stats_reference(data, topo, scale=0.3, causal=True, window=256)
    p = bsm.normalize_reference(data, m, l, topo, scale=0.3, causal=True, window=256, out_dtype=torch.float32)
    chain = ops_softmax.bsr_softmax(topo.with_data(data), scale=0.3, causal=True, window=256).data
    assert torch.allclose(p, chain, atol=1e-6)
    keep = bsm.window_keep(topo, 256)
    first = (topo.row_indices - topo.indices == 2)[:, None, None]  # the block two back: keys past the query's offset
    idx = torch.arange(128)
    assert torch.equal(keep & first, first & (idx[None, :] > idx[:, None])[None])


def test_yarn_frequencies_and_attention_factor():
    tcfg = serve_mellum2.transformer_config(FULL)
    inv = tr.rope_inv_freq(tcfg.rope, 128, True)
    base = 500000.0 ** (-torch.arange(0, 128, 2, dtype=torch.float64) / 128)
    low = math.floor(128 * math.log(8192 / (32 * 2 * math.pi)) / (2 * math.log(500000.0)))
    high = math.ceil(128 * math.log(8192 / (2 * math.pi)) / (2 * math.log(500000.0)))
    assert (low, high) == (18, 35)
    r = ((torch.arange(64, dtype=torch.float64) - 18) / 17).clamp(0, 1)
    assert torch.allclose(inv, base / 16 * r + base * (1 - r), rtol=1e-12)
    assert torch.equal(inv[:19], base[:19]) and torch.allclose(inv[35:], base[35:] / 16, rtol=1e-12)
    assert torch.allclose(inv, ref.inv_freq(FULL, "full"), rtol=1e-12)
    assert torch.equal(tr.rope_inv_freq(tcfg.rope, 128, False), base)
    cos_full, _ = tr.rope_tables(tcfg, "full", 0, 1, "cpu")
    cos_sliding, _ = tr.rope_tables(tcfg, "sliding", 0, 1, "cpu")
    assert torch.allclose(cos_full, torch.full_like(cos_full, 1.2772588722239782))
    assert torch.equal(cos_sliding, torch.ones_like(cos_sliding))


@pytest.mark.parametrize("renorm", [True, False])
def test_topk_renormalisation(renorm):
    """Every expert alike: y is one expert's output times the top-k
    probabilities' sum, which renormalisation makes 1."""
    cfg = moe.MoEConfig(d_model=128, d_ff=128, n_experts=16, capacity=128, dtype=torch.float32, top_k=4,
                        norm_topk_prob=renorm, activation="swiglu")
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    with torch.no_grad():
        params.w13.copy_(params.w13[:, :256].repeat(1, 16))
        params.w2.copy_(params.w2[:128].repeat(16, 1))
    x = torch.randn((40, 128), generator=torch.Generator().manual_seed(5))
    gu = x @ params.w13[:, :256]
    one = (F.silu(gu[:, :128]) * gu[:, 128:]) @ params.w2[:128]
    top = torch.softmax(x @ params.router, dim=-1).topk(4, dim=-1).values.sum(-1, keepdim=True)
    y = moe.topk_moe_forward(params, x, cfg)
    assert torch.allclose(y, one if renorm else one * top, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t", [3, 300])
def test_ragged_launches_compute_the_plain_ffn(t):
    """The two ragged launches, run on their plain version (the same
    descriptions the kernel gets), against the per-expert plain FFN, in
    bf16, on the routed rows."""
    cfg = moe.MoEConfig(d_model=128, d_ff=128, n_experts=16, capacity=128, top_k=4, norm_topk_prob=True,
                        activation="swiglu")
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    x = torch.randn((t, 128), generator=torch.Generator().manual_seed(7)).to(torch.bfloat16)
    tile = moe.tile_rows_for(t, cfg)
    p, dest, src, tile_expert, counts, tiles = moe._topk_route(x.float() @ params.router, cfg, tile)
    assert int(tiles.sum()) * tile >= t * 4 and int(counts.sum()) == t * 4
    assert tile_expert.shape[0] * tile == src.shape[0]
    got = mgk.ragged_swiglu_ffn(x[src], params.w13, params.w2, 16, tile_expert, tile, run=mgk.gemm_reference)
    want = mgk.ragged_swiglu_reference(x[src], params.w13, params.w2, 16, tile_expert, tile)
    assert torch.equal(got[dest], want[dest])


@pytest.mark.parametrize("trace", [True, False])
def test_the_cell_runs_through_the_harness(tmp_path, capsys, trace):
    root = tmp_path / "root"
    shutil.copytree(tiny.BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(tiny.BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "benchmark" / "configs" / "mellum2-12b-a2.5b.json").write_text(json.dumps(CFG))
    traffic = json.loads((tiny.BENCH / "traffic" / "complete.json").read_text())
    traffic.update(batch=2, prompt_lens=[512, 256], n_new=[4], max_len=640, check_requests=3)
    (root / "benchmark" / "traffic" / "complete.json").write_text(json.dumps(traffic))
    res = harness.run(root, "mellum2.complete", SEED, 0.3, trace, torch.device("cpu"), time.perf_counter())
    assert res["correct"] is True and res["checks"]["mean_logit_gap"]["value"] < 1e-3
    if not trace:  # the untraced window closes at a whole cycle of the schedule
        assert res["metrics"]["gen_tokens_per_s"]["value"] > 0
        batches = int(capsys.readouterr().err.split("window: ")[1].split(" batches")[0])
        assert batches >= 2 and batches % 2 == 0
        return
    assert res["metrics"]["moe_row_use_pct.complete"]["value"] > 0
    assert res["metrics"]["decode_host_ms.gen"]["value"] > 0 and res["metrics"]["first_token_ms.gen"]["value"] > 0
    assert 0 < res["metrics"]["attn_full_pct.complete"]["value"] < 100


MEGABLOCKS = [tr.TransformerConfig(),
              tr.TransformerConfig(d_model=256, n_heads=4, seq_len=256, window_blocks=1, n_experts=4, d_ff=128,
                                   n_layers=2, vocab=512, dtype=torch.float32)]


@pytest.mark.parametrize("cfg", MEGABLOCKS)
def test_megablocks_defaults_build_the_same_leaves(cfg):
    """The leaves, their shapes, dtypes and drawn values, as the model built
    them before layer kinds, GQA and the top-k MoE: embed, lnf, then per
    block wqkv (d, 3d), wo (d, d), two layernorms and the top-1 MoE, drawn
    in that order at normal / sqrt(fan-in)."""
    lm = tr.init_lm_params(cfg, torch.Generator().manual_seed(8), device="cpu")
    d, e, f, v = cfg.d_model, cfg.n_experts, cfg.d_ff, cfg.vocab
    want = [("embed", (v, d), cfg.dtype), ("lnf_scale", (d,), torch.float32), ("lnf_bias", (d,), torch.float32)]
    for i in range(cfg.n_layers):
        p = f"blocks.{i}."
        want += [(p + "wqkv", (d, 3 * d), cfg.dtype), (p + "wo", (d, d), cfg.dtype)]
        want += [(p + n, (d,), torch.float32) for n in ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")]
        want += [(p + "moe.router", (d, e), torch.float32), (p + "moe.w1", (d, e * f), cfg.dtype),
                 (p + "moe.w2", (e * f, d), cfg.dtype)]
    assert [(n, tuple(t.shape), t.dtype) for n, t in lm.named_parameters()] == want
    g = torch.Generator().manual_seed(8)
    draw = lambda shape, std: (torch.randn(shape, generator=g) * std)  # noqa: E731
    s = 1 / math.sqrt(d)
    drawn = {"embed": draw((v, d), s)}
    for i in range(cfg.n_layers):
        p = f"blocks.{i}."
        drawn[p + "wqkv"], drawn[p + "wo"] = draw((d, 3 * d), s), draw((d, d), s)
        drawn[p + "moe.router"], drawn[p + "moe.w1"] = draw((d, e), s), draw((d, e * f), s)
        drawn[p + "moe.w2"] = draw((e * f, d), 1 / math.sqrt(f))
    params = dict(lm.named_parameters())
    assert all(torch.equal(params[n].detach(), t.to(params[n].dtype)) for n, t in drawn.items())
    assert cfg.kv_heads == cfg.n_heads and cfg.kind(0) == "band" and cfg.moe_cfg().top_k == 1


def _attention_problem(kind):
    """(q, k, v, topology, causal) of a Mellum2-style prefill layer at T 256
    (4 / 2 heads of 128, bf16, causal, host-known metadata), with the one
    change ``kind`` names."""
    t, dtype = 256, torch.float32 if kind == "fp32" else torch.bfloat16
    dh = 64 if kind == "d_head_64" else 128
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g).to(dtype) for shape in ((4, t, dh), (2, t, dh), (2, t, dh)))
    topo = attention.causal_block_topology(t, window_blocks=2, dtype=dtype, device="cpu")
    if kind == "card_built":
        topo = dataclasses.replace(topo, host_offsets=None, host_indices=None)
    if kind in ("grad", "grad_under_no_grad"):
        q.requires_grad_()
    return q, k, v, topo, kind != "not_causal"


@pytest.mark.parametrize("kind,fits", [("prefill", True), ("grad_under_no_grad", True), ("fp32", False),
                                       ("d_head_64", False), ("not_causal", False), ("card_built", False),
                                       ("grad", False)])
def test_bsr_attention_predicate(monkeypatch, kind, fits):
    """bsr_attention's kernel takes bf16 at head dim 128 under the causal
    mask on host-known metadata while no gradient is recorded, and refuses
    each of the rest; the device check is made to pass on the CPU, so that
    every other condition is asked."""
    monkeypatch.setattr(fm, "_on_cuda", lambda *a, **kw: True)
    q, k, v, topo, causal = _attention_problem(kind)
    with torch.no_grad() if kind == "grad_under_no_grad" else torch.enable_grad():
        assert fm.attention_fits(q, k, v, topo, causal=causal, scale=128 ** -0.5, window=128) is fits


def test_forced_variant_keeps_the_chain(monkeypatch):
    """Inside forced_variant("torch_reference") the route dispatches nothing
    even where the predicate holds: the chain runs on the forced variant."""
    monkeypatch.setattr(fm, "_on_cuda", lambda *a, **kw: True)
    q, k, v, topo, _ = _attention_problem("prefill")
    kw = dict(causal=True, scale=128 ** -0.5, window=0)
    assert fm.attention_fits(q, k, v, topo, **kw)
    with registry.forced_variant("torch_reference"):
        assert registry.dispatch_if_fits("bsr_attention", q, k, v, topo, **kw) is None


def _dispatches(fn):
    start = tracing.position()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, {n: c for n, c in tracing.since(start).counters.items() if n.startswith("dispatch.")}


@pytest.mark.parametrize("x,want", [(3, 6), (-3, None)])
def test_dispatch_if_fits_asks_the_predicate_once(monkeypatch, x, want):
    """dispatch_if_fits asks the predicate once a call, launches the variant
    that takes the problem and counts that one dispatch; where none takes
    it, it returns None and counts nothing."""
    asked = []
    monkeypatch.setitem(registry._REGISTRY, "_probe_op", [])
    registry.register("_probe_op", "probe", lambda y: asked.append(y) or y > 0, lambda y: 2 * y)
    got, counts = _dispatches(lambda: registry.dispatch_if_fits("_probe_op", x))
    assert got == want and asked == [x]
    assert counts == ({"dispatch._probe_op.probe": 1} if want else {})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unfused_attention_on_the_cpu_is_the_chain(dtype):
    """On the CPU multihead_block_sparse_attention runs SDD, the softmax and
    DSD (K, V repeated to the query heads) with the dispatches those three
    ops count when called alone, and their bits; no bsr_attention."""
    q, k, v, _, _ = _attention_problem("fp32" if dtype == torch.float32 else "prefill")
    topo = attention.causal_block_topology(256, window_blocks=2, dtype=dtype, device="cpu")
    got, counts = _dispatches(lambda: attention.multihead_block_sparse_attention(q, k, v, topo, causal=True,
                                                                                 window=128))
    want, chain_counts = _dispatches(lambda: ops.dsd(ops.bsr_softmax(
        ops.sdd(q, k.repeat_interleave(2, 0), topo, transpose_b=True), scale=128 ** -0.5, causal=True, window=128),
        v.repeat_interleave(2, 0)))
    assert counts == chain_counts and not [n for n in counts if "bsr_attention" in n]
    assert torch.equal(got, want)
