"""The port's spans, marks and counters (``sputnik_tpu_torch/utils/tracing.py``)
on the CPU: nothing recorded and nothing changed with no profiler active;
under a CPU ``torch.profiler``, the spans of a generation call and of a
training step's forward and backward, with their parents, calls and rows,
on the profiler's clock; the MoE and dispatch counters against plain
counts; and the benchmark's per-layer metrics that read them, on its tiny
traced cells."""

import collections
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny, tiny_source
from sputnik_tpu_torch.models import moe
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import tracing

CFG = tr.TransformerConfig(d_model=128, n_heads=2, seq_len=256, window_blocks=1, n_experts=4, d_ff=128,
                           n_layers=2, vocab=256, dtype=torch.float32)
B, N_NEW = 2, 4
SEED = 2**31 + 77


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _run(model):
    """Logits, loss, every gradient and generated tokens of the tiny LM, on
    one thread (the embedding's scatter-add backward sums in thread order)."""
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, CFG.vocab, (CFG.seq_len,), generator=g)
    prompts = torch.randint(0, CFG.vocab, (B, 128), generator=g)
    model.zero_grad(set_to_none=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        logits, _ = tr.lm_forward(model, tokens, CFG)
        loss = tr.lm_loss(model, tokens, CFG)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        out = tr.lm_generate_batched(model, prompts, CFG, N_NEW, max_len=256)
    finally:
        torch.set_num_threads(threads)
    return logits.detach(), loss.detach(), grads, out


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo += [n for n, _ in node.next_functions]
    return names


@pytest.fixture(scope="module")
def model():
    return tr.init_lm_params(CFG, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def traced(model):
    """The tiny LM's run under a CPU profiler: (outputs, window, profiler)."""
    start = tracing.position()
    with _profile() as prof:
        out = _run(model)
    return out, tracing.since(start), prof


def test_off_records_nothing_and_enters_no_range(model, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    start = tracing.position()
    _run(model)
    w = tracing.since(start)
    assert w.spans == [] and w.marks == [] and w.counters == {}
    loss = tr.lm_loss(model, torch.arange(CFG.seq_len) % CFG.vocab, CFG)
    assert not [n for n in _graph_names(loss) if "Marker" in n]


def test_off_and_on_are_bitwise_equal(model, traced):
    (logits, loss, grads, out), _, _ = traced
    off = _run(model)
    assert torch.equal(off[0], logits) and torch.equal(off[1], loss) and torch.equal(off[3], out)
    assert off[2].keys() == grads.keys() and all(torch.equal(off[2][n], g) for n, g in grads.items())


def test_a_traced_graph_carries_the_markers(model):
    with _profile():
        loss = tr.lm_loss(model, torch.arange(CFG.seq_len) % CFG.vocab, CFG)
    names = collections.Counter(n for n in _graph_names(loss) if "Marker" in n)
    assert names == {"_MarkerBackward": 4 * CFG.n_layers}


def test_generate_spans_parents_and_calls(traced):
    _, w, _ = traced
    by_id = {s.id: s for s in w.spans}
    gen, = [s for s in w.spans if s.name == "generate"]
    assert gen.parent is None and gen.call is not None and gen.end is not None
    prefill = [s for s in w.spans if s.name == "prefill"]
    steps = [s for s in w.spans if s.name == "decode_step"]
    assert [s.row for s in prefill] == list(range(B)) and len(steps) == N_NEW - 1
    assert all(s.parent == gen.id and s.call == gen.call for s in prefill + steps)
    for p in prefill + steps:
        kids = [s for s in w.spans if s.parent == p.id]
        assert sorted(s.name for s in kids) == ["attention"] * CFG.n_layers + ["moe"] * CFG.n_layers
        assert all(s.call == gen.call and s.row == p.row for s in kids)
        assert all(p.start.ns <= s.start.ns <= s.end.ns <= p.end.ns for s in kids)
    mark, = w.marks
    assert (mark.name, mark.parent, mark.call, mark.rows) == ("first_token", gen.id, gen.call, B)
    assert prefill[-1].end.ns <= mark.at.ns <= steps[0].start.ns
    # Nothing of the generation call leaks outside it.
    assert all(by_id[s.parent].call == s.call for s in w.spans if s.parent in by_id)


def test_backward_spans_in_reverse_layer_order(traced):
    _, w, _ = traced
    loss, = [s for s in w.spans if s.name == "loss"]
    fwd = [s for s in w.spans if s.parent == loss.id]
    assert [s.name for s in fwd] == ["attention", "moe"] * CFG.n_layers
    bwd = [s for s in w.spans if s.name.endswith(".backward")]
    by_id = {s.id: s for s in fwd}
    # Caused by its forward span, from the last layer's MoE down.
    assert [by_id[s.parent] for s in bwd] == fwd[::-1]
    assert all(s.name == by_id[s.parent].name + ".backward" and s.call is None for s in bwd)
    assert all(a.end.ns <= b.start.ns for a, b in zip(bwd, bwd[1:]))
    assert all(loss.end.ns <= s.start.ns < s.end.ns for s in bwd)


def test_spans_lie_on_the_profilers_clock(traced):
    _, w, prof = traced
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            events[e.name()[len(tracing.PREFIX):]].append((e.start_ns(), e.end_ns()))
    stored = collections.defaultdict(list)
    for s in w.spans:
        stored[s.name].append((s.start.ns, s.end.ns))
    assert set(events) == set(stored) == {"loss", "attention", "moe", "attention.backward", "moe.backward",
                                          "generate", "prefill", "decode_step"}
    for name, spans in stored.items():
        assert len(events[name]) == len(spans), name
        for (s0, s1), (e0, e1) in zip(sorted(spans), sorted(events[name])):
            assert abs(s0 - e0) <= 1e6 and abs(s1 - e1) <= 1e6, name


@pytest.mark.parametrize("impl", ["grouped", "bsr", "bsr_unfused"])
def test_moe_counters_match_the_routing(impl):
    """A router that sends three quarters of the tokens to expert 0, past
    its capacity: the counters equal a plain count of _route's decisions."""
    cfg = moe.MoEConfig(d_model=128, d_ff=128, n_experts=2, capacity=128, dtype=torch.float32)
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    x = torch.randn(384, cfg.d_model, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        params.router.zero_()
        params.router[0, 0] = 1.0
        x[:, 0] = torch.where(torch.arange(384) % 4 == 0, -1.0, 1.0)
    _, keep, _, _ = moe._route(moe.router_logits(params, x, cfg), cfg)
    topo = moe.block_diag_topology(cfg, device="cpu")
    start = tracing.position()
    with _profile():
        moe.moe_forward(params, x, cfg, topo, impl=impl)
    counters = tracing.since(start).counters
    assert int(keep.sum()) == 128 + 96
    assert {k: v for k, v in counters.items() if k.startswith("moe.")} == {
        "moe.tokens_routed": 384, "moe.tokens_kept": int(keep.sum()), "moe.slots_computed": 2 * 128}


def test_dispatch_counter_is_the_selected_variants(model, monkeypatch):
    chosen = collections.Counter()
    select = registry._select

    def recording_select(op, args, kwargs, variant=None):
        v = select(op, args, kwargs, variant)
        chosen[f"dispatch.{op}.{v.name}"] += 1
        return v

    monkeypatch.setattr(registry, "_select", recording_select)
    start = tracing.position()
    with _profile():
        tr.lm_loss(model, torch.arange(CFG.seq_len) % CFG.vocab, CFG).backward()
    counters = tracing.since(start).counters
    assert chosen and {k: v for k, v in counters.items() if k.startswith("dispatch.")} == chosen


def test_store_cap_counts_what_it_loses(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", len(tracing._STORE.spans) + 1)
    start = tracing.position()
    with _profile():
        for _ in range(3):
            with tracing.span("x", None):
                pass
    w = tracing.since(start)
    assert len(w.spans) == 1 and w.counters == {"tracing.spans_lost": 2}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tiny, "BENCH", tiny_source.source(tmp_path_factory.mktemp("tracing_src")))
        return tiny.make(tmp_path_factory.mktemp("tracing"))


@pytest.mark.parametrize("cell,names", [
    ("tiny.train", ["moe_backward_ms.train", "attn_backward_ms.train", "moe_slot_use_pct.train",
                    "kernel_route_pct.train"]),
    ("tiny.gen", ["first_token_ms.gen", "decode_host_ms.gen"]),
    ("tiny.prompt", ["first_token_ms.prompt", "moe_slot_use_pct.prompt"]),
])
def test_traced_tiny_cells_report_the_new_metrics(tiny_root, monkeypatch, cell, names):
    """Each new metric is read in its traced tiny cell; the slot share is
    exactly the kept tokens that _route decided while recording, over E x
    capacity per grouped call (tiny.train: 256 tokens over 4 x 128 slots,
    so 50% less the drops), and no CPU dispatch takes a cuda_* variant."""
    kept, calls = [], []
    route = moe._route

    def counting_route(logits, cfg):
        out = route(logits, cfg)
        if tracing.recording():
            kept.append(int(out[1].sum()))
            calls.append(cfg.padded_tokens)
        return out

    monkeypatch.setattr(moe, "_route", counting_route)
    res = harness.run(tiny_root, cell, SEED, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert res["correct"] is True
    got = {n: res["metrics"][n]["value"] for n in names}
    assert all(v >= 0 for v in got.values()), got
    for n in names:
        if n.startswith("moe_slot_use_pct"):
            assert got[n] == 100.0 * sum(kept) / sum(calls)
        if n.endswith("_ms.train") or n.startswith(("first_token", "decode_host")):
            assert got[n] > 0
    if cell == "tiny.train":
        assert set(calls) == {4 * 128} and got["moe_slot_use_pct.train"] <= 50.0
        assert got["kernel_route_pct.train"] == 0.0
