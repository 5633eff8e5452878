"""Serving traffic: batches of requests through the port's
``lm_generate_batched``.

Batch ``i`` holds ``batch`` requests that share one prompt length
(``lm_generate_batched`` takes (B, Tp)); its prompt length and its number
of new tokens cycle through the traffic file's ``prompt_lens`` and
``n_new``, the same schedule for every seed. The seed draws the token ids
(uniform over the vocabulary) and the weights. Arrivals: ``closed_loop``
(one client sends the next batch when the last returns) or a fixed rate of
``batches_per_s`` (batch ``i`` is due ``i / rate`` after the window
opens, is sent when due or when the previous batch returns, and every
batch due inside the window is served). A request's latency runs from its
batch's due time (its send, in a closed loop) to the return of
``lm_generate_batched``, synchronised on the token ids. Set-up warms every
prompt length of the schedule at the traffic's batch. After the window a
sample of the finished requests (``check_requests`` of them drawn from
the seed with the longest among them, or all) is compared with the plain
reference, by the numbers that the cell's limits file names.
"""

from __future__ import annotations

import random
import statistics
import time
from typing import Dict

import torch

from benchmark import compare, harness, weights
from benchmark.reference import model as ref


def schedule(tr: Dict, i: int):
    return tr["prompt_lens"][i % len(tr["prompt_lens"])], tr["n_new"][i % len(tr["n_new"])]


def prompts(cfg: Dict, tr: Dict, seed: int, i: int, device) -> torch.Tensor:
    tp, _ = schedule(tr, i)
    g = weights.generator(seed, f"prompt:{i}", device)
    return torch.randint(0, cfg["vocab"], (tr["batch"], tp), generator=g, device=device)


def serve(ctx: harness.Context, model, tcfg, units=None):
    """The window: returns the finished batches [(i, due, done, tokens)] and
    the window's end."""
    from sputnik_tpu_torch.models import transformer
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    rate = tr.get("batches_per_s")
    done = []
    t0 = harness.now()
    i = 0
    while True:
        due = t0 if rate is None else t0 + i / rate
        if units is not None:
            if i >= units:
                break
        elif (due if rate is not None else harness.now()) - t0 >= ctx.seconds:
            break
        wait = due - harness.now()
        if wait > 0:
            time.sleep(wait)
        sent = harness.now()
        tp, n_new = schedule(tr, i)
        out = transformer.lm_generate_batched(model, prompts(cfg, tr, ctx.seed, i, dev), tcfg, n_new,
                                              max_len=tr["max_len"], mode=tr["mode"], temperature=0.0)
        out = out.cpu()
        done.append((i, due if rate is not None else sent, harness.now(), out))
        i += 1
    return t0, done


def sample(ctx: harness.Context, done, n):
    """(batch, row) of the requests compared: every finished one when ``n``
    is None, else the longest first and ``n - 1`` more drawn from the seed."""
    tr = ctx.cell.traffic
    reqs = [(i, r) for i, *_ in done for r in range(tr["batch"])]
    if n is None:
        return reqs
    longest = max(reqs, key=lambda ir: sum(schedule(tr, ir[0])))
    rest = [q for q in reqs if q != longest]
    rng = random.Random(weights.derive(ctx.seed, "sample"))
    return [longest] + rng.sample(rest, min(n - 1, len(rest)))


def reference_logits(cfg: Dict, tr: Dict, seed: int, picked, tokens, device, precision="fp32", margins=None):
    """The reference's logits at every served position of the picked
    requests, and their served tokens."""
    ref.exact()
    seqs, tps, served = [], [], []
    for (i, r), out in zip(picked, tokens):
        p = prompts(cfg, tr, seed, i, device)[r]
        seqs.append(torch.cat([p, out.to(device)]))
        tps.append(p.shape[0])
        served.append(out)
    logits = ref.served_logits(lambda name: weights.draw(cfg, seed, name, device), cfg, seqs, tps, precision, margins)
    return logits, served


def run(ctx: harness.Context) -> harness.Outcome:
    from sputnik_tpu_torch.models import transformer
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    tcfg = harness.transformer_config(cfg)
    model = transformer.SparseLM(tcfg, device=dev)
    weights.fill_module(model, cfg, ctx.seed)
    variants = harness.Variants()
    # Warm-up: a prefill at every prompt length of the schedule, then the
    # decode step at the traffic's batch.
    lens = sorted(set(tr["prompt_lens"]))
    for rows, tp, n_new in [(1, tp, 1) for tp in lens[1:]] + [(tr["batch"], lens[0], 2)]:
        g = weights.generator(ctx.seed, f"warm:{tp}", dev)
        warm = torch.randint(0, cfg["vocab"], (rows, tp), generator=g, device=dev)
        transformer.lm_generate_batched(model, warm, tcfg, n_new, max_len=tr["max_len"], mode=tr["mode"],
                                        temperature=0.0).cpu()
    routes = variants.restore()
    harness.sync(dev)
    setup_s = harness.now() - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if ctx.ranges is not None:
        ctx.ranges.recording = True
    with ctx.traced() as prof:
        with ctx.window():
            t0, done = serve(ctx, model, tcfg, tr["trace_units"] if ctx.trace else None)
            harness.sync(dev)
    if ctx.ranges is not None:
        ctx.ranges.recording = False
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    b = tr["batch"]
    tokens = sum(b * schedule(tr, i)[1] for i, *_ in done)
    lat_ms = [(t - due) * 1e3 for _, due, t, _ in done for _ in range(b)]
    e2e = {"setup_s": setup_s, "gen_tokens_per_s": tokens / (done[-1][2] - t0)}
    if len(lat_ms) >= 2:
        e2e["request_p95_ms"] = statistics.quantiles(lat_ms, n=100)[94]
    work = {"prefill": [schedule(tr, i)[0] for i, *_ in done for _ in range(b)],
            "decode": [(b, schedule(tr, i)[0] + j) for i, *_ in done for j in range(schedule(tr, i)[1] - 1)]}
    notes = [f"dispatch: {routes}",
             f"window: {len(done)} batches, {len(lat_ms)} requests, {tokens} tokens in {done[-1][2] - t0:.3f} s; "
             f"latency ms median {statistics.median(lat_ms):.3f} p95 {e2e.get('request_p95_ms', float('nan')):.3f} "
             f"over {len(lat_ms)} requests; late start {max(0.0, done[-1][2] - t0 - ctx.seconds):.3f} s past "
             f"the close; setup {setup_s:.3f} s; memory peak {peak} bytes"]
    outcome = harness.Outcome(attempted=len(lat_ms), failed=0, end_to_end=e2e, checks={}, memory_peak_bytes=peak,
                              work=work, prof=prof, notes=notes)
    ctx.after_window(outcome)
    del model, prof
    outcome.prof = None
    harness.free(dev)
    picked = sample(ctx, done, tr["check_requests"])
    out_of = {i: out for i, _, _, out in done}
    logits, served = reference_logits(cfg, tr, ctx.seed, picked, [out_of[i][r] for i, r in picked], dev)
    stats = compare.gap_stats(compare.token_gaps(logits, served))
    outcome.checks = {name: stats[name] for name in ctx.cell.limits}
    outcome.notes.append(f"compared {sum(len(s) for s in served)} served tokens of {len(picked)} requests")
    return outcome
