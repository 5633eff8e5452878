"""attn_roofline.complete: Percent: prefill attention's least time (flops_mellum2.py: the pairs each layer kind
allows, q, k, v and o once) over the device time of the port's sputnik.attention spans inside a prefill (CUDA
events around bsr_sdd, the windowed bsr_softmax and bsr_dsd_stream at head dim 128). The spans are read, not the
benchmark's ranges, which would keep every call's q, k and v alive through the window."""

from benchmark import flops_mellum2 as fm
from benchmark import spans

START = spans.start()


def read(r):
    w = spans._window(START)
    if w is None:
        return None
    by_id = {s.id: s for s in w.spans}
    prompt_of = dict(zip((s.id for s in w.spans if s.name == "prefill"), r.work["prefill"]))
    least = device_s = 0.0
    for s in w.spans:
        kind = by_id.get(s.parent)
        if s.name != "attention" or s.end is None or kind is None or kind.parent not in prompt_of:
            continue
        least += fm.least_time(*fm.attention(r.config, prompt_of[kind.parent], kind.name.split(".")[1]))
        device_s += s.device_ms() * 1e-3
    return 100.0 * least / device_s if device_s > 0 else None
