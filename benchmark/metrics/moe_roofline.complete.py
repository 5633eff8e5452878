"""moe_roofline.complete: Percent: the top-k MoE's least time (flops_mellum2.py) over the device time of the port's
sputnik.moe spans (CUDA events around topk_moe_forward: the routing and the ragged SwiGLU moe_grouped launches),
in prefills and decode steps. Expert bytes come from the port's device counter moe.experts_used: a call of t
tokens with t * k >= 64 E routed rows is taken to touch every expert (a miss is e^-64 likely), and the rest of the
count is shared evenly by the other calls (decode steps, bound by bytes, so the split among them does not change
the sum). The spans are read, not the benchmark's ranges, which would keep every call's input alive."""

from benchmark import flops_mellum2 as fm
from benchmark import spans

START = spans.start()


def read(r):
    w = spans._window(START)
    if w is None or not w.counters.get("moe.experts_used"):
        return None
    tokens_of = dict(zip((s.id for s in w.spans if s.name == "prefill"), r.work["prefill"]))
    tokens_of.update(zip((s.id for s in w.spans if s.name == "decode_step"), (b for b, _ in r.work["decode"])))
    calls = [(tokens_of[s.parent], s.device_ms() * 1e-3) for s in w.spans
             if s.name == "moe" and s.end is not None and s.parent in tokens_of]
    device_s = sum(ms for _, ms in calls)
    if not calls or device_s <= 0:
        return None
    cfg = r.config
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    large = [t * k >= 64 * e for t, _ in calls]
    rest = max(w.counters["moe.experts_used"] - e * sum(large), 0) / max(len(calls) - sum(large), 1)
    least = sum(fm.least_time(*fm.moe(cfg, t, e if big else rest)) for (t, _), big in zip(calls, large))
    return 100.0 * least / device_s
