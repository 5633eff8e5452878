"""Training traffic: the caller's loop over the port's ``lm_loss``.

Set-up builds one training object (the model filled from the seed, the
topologies, ``torch.optim.Adam``) and drives it through the first
``reference_steps`` optimizer steps with the window's own step and feed;
those steps are also the warm-up. Their readings (each step's loss, the
first gradient per leaf from Adam's state after one step, the parameters'
change per leaf after the last of them) are compared with the plain
reference after the window. A step is ``global_batch_sequences``
micro-batches of one sequence (``lm_loss`` takes one), each followed by
``backward()`` on its loss over the step's count, then ``Adam.step()`` and
``zero_grad()``. Every sequence is drawn uniformly over the vocabulary from
the seed and the step's number.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

from benchmark import compare, harness, weights
from benchmark.reference import model as ref


def batch(cfg: Dict, seed: int, step: int, device) -> torch.Tensor:
    """Step ``step``'s (sequences, seq_len) token ids."""
    g = weights.generator(seed, f"train:{step}", device)
    return torch.randint(0, cfg["vocab"], (cfg["global_batch_sequences"], cfg["seq_len"]), generator=g, device=device)


def program_readings(ctx: harness.Context, steps: int):
    """Build the training object, run its first ``steps`` steps, and return
    (step function, its state, the readings)."""
    from sputnik_tpu_torch.models import transformer
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    tcfg = harness.transformer_config(cfg)
    model = transformer.SparseLM(tcfg, device=dev)
    weights.fill_module(model, cfg, ctx.seed)
    topos = transformer.lm_topologies(tcfg, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=tr["lr"], betas=tuple(tr["betas"]), eps=tr["eps"])

    def step(tokens: torch.Tensor) -> torch.Tensor:
        total = torch.zeros((), device=tokens.device)
        for i in range(tokens.shape[0]):
            lo = transformer.lm_loss(model, tokens[i], tcfg, topos)
            (lo / tokens.shape[0]).backward()
            total = total + lo.detach()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return total / tokens.shape[0]

    params = dict(model.named_parameters())
    losses, grad = [], {}
    for s in range(1, steps + 1):
        losses.append(float(step(batch(cfg, ctx.seed, s, dev))))
        if s == 1:
            for n, p in params.items():
                m = opt.state.get(p, {}).get("exp_avg")
                grad[n] = 0.0 if m is None else float(m.float().norm()) / (1 - tr["betas"][0])
    with torch.no_grad():
        change = {n: float((params[n].float() - p0.float()).norm()) for n, p0 in weights.draw_all(cfg, ctx.seed, dev)}
    return step, (model, opt, topos), {"loss": losses, "grad": grad, "change": change}


def reference_readings(cfg: Dict, tr: Dict, seed: int, device, precision: str = "fp32") -> Dict:
    """The plain reference's readings of the same first steps."""
    ref.exact()
    specs = {n: dtype for n, _, dtype, _ in weights.leaf_specs(cfg)}
    params = {n: t.float().requires_grad_() for n, t in weights.draw_all(cfg, seed, device)}
    losses, grad = ref.adam_steps(params, specs, lambda s: list(batch(cfg, seed, s, device)), cfg,
                                  tr["reference_steps"], tr["lr"], tuple(tr["betas"]), tr["eps"], precision)
    with torch.no_grad():
        change = {n: float((params[n] - p0.float()).norm()) for n, p0 in weights.draw_all(cfg, seed, device)}
    return {"loss": losses, "grad": grad, "change": change}


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    variants = harness.Variants()
    step, state, prog = program_readings(ctx, tr["reference_steps"])
    routes = variants.restore()
    harness.sync(dev)
    notes = [f"dispatch: {routes}"]
    t0 = harness.now()
    setup_s = t0 - ctx.t_start
    n_steps, t_end, k, step_s = 0, t0, tr["reference_steps"] + 1, []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    units = tr["trace_units"] if ctx.trace else None
    if ctx.ranges is not None:
        ctx.ranges.recording = True
    with ctx.traced() as prof:
        with ctx.window():
            while (units is None and harness.now() - t0 < ctx.seconds) or (units is not None and n_steps < units):
                float(step(batch(cfg, ctx.seed, k, dev)))
                t = harness.now()
                step_s.append(t - t_end)
                t_end = t
                n_steps += 1
                k += 1
            harness.sync(dev)
    if ctx.ranges is not None:
        ctx.ranges.recording = False
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    seqs = n_steps * cfg["global_batch_sequences"]
    tokens = seqs * cfg["seq_len"]
    e2e = {"train_tokens_per_s": tokens / (t_end - t0), "setup_s": setup_s}
    q = statistics.quantiles(step_s, n=4) if len(step_s) > 1 else step_s * 3
    notes.append(f"window: {n_steps} steps, {tokens} tokens in {t_end - t0:.3f} s; step s quartiles "
                 f"{q[0]:.4f} / {q[1]:.4f} / {q[2]:.4f}, max {max(step_s):.4f}; setup {setup_s:.3f} s; "
                 f"memory peak {peak} bytes")
    outcome = harness.Outcome(attempted=seqs, failed=0, end_to_end=e2e, checks={}, memory_peak_bytes=peak,
                              work={"train_sequences": seqs, "seq_len": cfg["seq_len"]}, prof=prof, notes=notes)
    ctx.after_window(outcome)
    del step, state, prof
    outcome.prof = None
    harness.free(dev)
    outcome.checks = compare.train(prog, reference_readings(cfg, tr, ctx.seed, dev))
    outcome.notes.append(f"the program's losses of the first {tr['reference_steps']} steps: {prog['loss']}")
    return outcome
