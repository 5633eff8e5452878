"""Serving traffic on Mellum2: the ``serve`` driver's batches and sample
(``serve.schedule``, ``prompts``, ``sample``, unchanged; ``serve.serve``
for a traced run's units, and for the untraced window its closed loop
closed at a whole cycle of the schedule, :func:`serve_cycles`) on the
port's ``SparseLM`` built with Mellum2's layer kinds, GQA, RoPE / YaRN,
RMSNorm, top-k SwiGLU experts and untied head, compared with
``reference/mellum2.py``.

The port's configuration is built from those fields alone, so a port
without them fails at once, before the window.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

from benchmark import compare, harness, weights, weights_mellum2
from benchmark.drivers import serve
from benchmark.reference import mellum2 as ref


def transformer_config(cfg: Dict):
    """The port's configuration of a Mellum2-style config file."""
    from sputnik_tpu_torch.models.transformer import RopeConfig, TransformerConfig
    full = cfg["rope_parameters"]["full_attention"]
    if cfg["rope_parameters"]["sliding_attention"]["rope_theta"] != full["rope_theta"]:
        raise ValueError("the port's layers share one rope theta")
    rope = RopeConfig(theta=float(full["rope_theta"]), yarn_factor=float(full["factor"]),
                      original_max_position=full["original_max_position_embeddings"],
                      beta_fast=float(full["beta_fast"]), beta_slow=float(full["beta_slow"]),
                      attention_factor=float(full["attention_factor"]))
    return TransformerConfig(
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"], seq_len=cfg["max_position_embeddings"], n_experts=cfg["num_experts"],
        d_ff=cfg["moe_intermediate_size"], n_layers=cfg["num_hidden_layers"], vocab=cfg["vocab_size"],
        dtype=weights.DTYPES[cfg["dtype"]], norm="rmsnorm", rope=rope,
        layer_kinds=tuple("full" if k == "full_attention" else "sliding" for k in cfg["layer_types"]),
        window=cfg["sliding_window"], top_k=cfg["num_experts_per_tok"], norm_topk_prob=cfg["norm_topk_prob"],
        moe_route="dropless", tied_head=cfg["tie_word_embeddings"],
    )


def serving_config(cfg: Dict) -> Dict:
    """The config file with the ``vocab`` key that ``serve.prompts`` reads."""
    return dict(cfg, vocab=cfg["vocab_size"])


def build(cfg: Dict, seed: int, device):
    """(port configuration, model with the seed's weights)."""
    from sputnik_tpu_torch.models import transformer
    tcfg = transformer_config(cfg)
    model = transformer.SparseLM(tcfg, device=device)
    weights_mellum2.fill_module(model, cfg, seed)
    return tcfg, model


def reference_logits(cfg: Dict, tr: Dict, seed: int, picked, tokens, device, precision="fp32", margins=None):
    """The reference's logits at every served position of the picked
    requests (``cfg``: :func:`serving_config`), and their served tokens."""
    seqs, tps, served = [], [], []
    for (i, r), out in zip(picked, tokens):
        p = serve.prompts(cfg, tr, seed, i, device)[r]
        seqs.append(torch.cat([p, out.to(device)]))
        tps.append(p.shape[0])
        served.append(out)
    logits = ref.served_logits(lambda name: weights_mellum2.draw(cfg, seed, name, device), cfg, seqs, tps,
                               precision, margins)
    return logits, served


def serve_cycles(ctx: harness.Context, model, tcfg):
    """The untraced window: ``serve.serve``'s closed loop, batch ``i`` of
    ``serve.schedule`` with ``serve.prompts``, closed at the end of the
    first whole cycle of the schedule at or past ``--seconds``, so that
    every window holds the same mix of prompt lengths whatever the host's
    speed. Returns the window's start and the finished batches [(i, sent,
    done, tokens)], as ``serve.serve`` does."""
    from sputnik_tpu_torch.models import transformer
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cycle = math.lcm(len(tr["prompt_lens"]), len(tr["n_new"]))
    done = []
    t0 = harness.now()
    while len(done) % cycle or harness.now() - t0 < ctx.seconds:
        i, sent = len(done), harness.now()
        out = transformer.lm_generate_batched(model, serve.prompts(cfg, tr, ctx.seed, i, dev), tcfg,
                                              serve.schedule(tr, i)[1], max_len=tr["max_len"], mode=tr["mode"],
                                              temperature=0.0)
        done.append((i, sent, harness.now(), out.cpu()))
    return t0, done


def run(ctx: harness.Context) -> harness.Outcome:
    from sputnik_tpu_torch.models import transformer
    ctx.cell.config = cfg = serving_config(ctx.cell.config)
    tr, dev = ctx.cell.traffic, ctx.device
    tcfg, model = build(cfg, ctx.seed, dev)
    variants = harness.Variants()
    # Warm-up: a prefill at every prompt length of the schedule, then the
    # decode step at the traffic's batch.
    lens = sorted(set(tr["prompt_lens"]))
    for rows, tp, n_new in [(1, tp, 1) for tp in lens[1:]] + [(tr["batch"], lens[0], 2)]:
        g = weights.generator(ctx.seed, f"warm:{tp}", dev)
        warm = torch.randint(0, cfg["vocab"], (rows, tp), generator=g, device=dev)
        transformer.lm_generate_batched(model, warm, tcfg, n_new, max_len=tr["max_len"], temperature=0.0).cpu()
    routes = variants.restore()
    harness.sync(dev)
    setup_s = harness.now() - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if ctx.ranges is not None:
        ctx.ranges.recording = True
    with ctx.traced() as prof:
        with ctx.window():
            if ctx.trace:
                t0, done = serve.serve(ctx, model, tcfg, tr["trace_units"])
            else:
                t0, done = serve_cycles(ctx, model, tcfg)
            harness.sync(dev)
    if ctx.ranges is not None:
        ctx.ranges.recording = False
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    b = tr["batch"]
    tokens = sum(b * serve.schedule(tr, i)[1] for i, *_ in done)
    lat_ms = [(t - due) * 1e3 for _, due, t, _ in done for _ in range(b)]
    e2e = {"setup_s": setup_s, "gen_tokens_per_s": tokens / (done[-1][2] - t0)}
    work = {"prefill": [serve.schedule(tr, i)[0] for i, *_ in done for _ in range(b)],
            "decode": [(b, serve.schedule(tr, i)[0] + j) for i, *_ in done
                       for j in range(serve.schedule(tr, i)[1] - 1)]}
    notes = [f"dispatch: {routes}",
             f"window: {len(done)} batches, {len(lat_ms)} requests, {tokens} tokens in {done[-1][2] - t0:.3f} s; "
             f"batch ms " + ", ".join(f"{(t - due) * 1e3:.1f}" for _, due, t, _ in done)
             + f"; latency ms median {statistics.median(lat_ms):.3f}; setup {setup_s:.3f} s; memory peak {peak} bytes"]
    outcome = harness.Outcome(attempted=len(lat_ms), failed=0, end_to_end=e2e, checks={}, memory_peak_bytes=peak,
                              work=work, prof=prof, notes=notes)
    ctx.after_window(outcome)
    del model, prof
    outcome.prof = None
    harness.free(dev)
    picked = serve.sample(ctx, done, tr["check_requests"])
    out_of = {i: out for i, _, _, out in done}
    logits, served = reference_logits(cfg, tr, ctx.seed, picked, [out_of[i][r] for i, r in picked], dev)
    stats = compare.gap_stats(compare.token_gaps(logits, served))
    outcome.checks = {name: stats[name] for name in ctx.cell.limits}
    outcome.notes.append(f"compared {sum(len(s) for s in served)} served tokens of {len(picked)} requests")
    return outcome
