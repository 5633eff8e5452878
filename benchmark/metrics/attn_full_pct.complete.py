"""attn_full_pct.complete: Percent: device time of the port's sputnik.attention.full spans over that of the
sputnik.attention.full and sputnik.attention.sliding spans together (prefill and decode) in the traced window."""

from benchmark import spans

START = spans.start()


def read(r):
    w = spans._window(START)
    if w is None:
        return None
    ms = {kind: sum(s.device_ms() for s in w.spans if s.name == f"attention.{kind}" and s.end is not None)
          for kind in ("full", "sliding")}
    total = ms["full"] + ms["sliding"]
    return 100.0 * ms["full"] / total if total > 0 else None
