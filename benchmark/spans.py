"""Shared arithmetic of the per-layer metrics that read the port's own
spans and counters (``sputnik_tpu_torch/utils/tracing.py``).

A reader takes :func:`start` when the harness loads it, before the cell's
set-up, and reads what the port recorded after that point. The port
records only while a profiler is active, which in a ``--trace 1`` run is
the traced window alone. Each function returns None where there is nothing
to read, as on a port without the tracing module.
"""

from __future__ import annotations

import collections
import statistics
from typing import Optional


def _tracing():
    try:
        from sputnik_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def start():
    """The port's position now, or None on a port that records nothing."""
    tracing = _tracing()
    return None if tracing is None else tracing.position()


def _window(pos):
    return None if pos is None else _tracing().since(pos)


def first_token_ms(pos) -> Optional[float]:
    """Median over the requests of the device time from the start of their
    ``generate`` span to their call's ``first_token`` mark."""
    w = _window(pos)
    if w is None:
        return None
    tracing = _tracing()
    calls = {s.call: s for s in w.spans if s.name == "generate"}
    times = []
    for m in w.marks:
        if m.name == "first_token" and m.call in calls:
            times += [tracing.elapsed_ms(calls[m.call].start, m.at)] * m.rows
    return statistics.median(times) if times else None


def host_ms(pos, name: str) -> Optional[float]:
    """Median host duration of the closed spans called ``name``."""
    w = _window(pos)
    times = [] if w is None else [s.host_ms() for s in w.spans if s.name == name and s.end is not None]
    return statistics.median(times) if times else None


def backward_ms(pos, layer: str) -> Optional[float]:
    """Median over training micro-batches (``loss`` spans) of the summed
    device time of their ``<layer>.backward`` spans."""
    w = _window(pos)
    if w is None:
        return None
    by_id = {s.id: s for s in w.spans}
    per_loss = collections.defaultdict(float)
    for s in w.spans:
        if s.name != f"{layer}.backward" or s.end is None:
            continue
        fwd = by_id.get(s.parent)
        root = by_id.get(fwd.parent) if fwd is not None else None
        if root is not None and root.name == "loss":
            per_loss[root.id] += s.device_ms()
    return statistics.median(per_loss.values()) if per_loss else None


def slot_use_pct(pos) -> Optional[float]:
    """Percent of the grouped MoE's capacity slots that held a kept token."""
    w = _window(pos)
    if w is None or not w.counters.get("moe.slots_computed"):
        return None
    return 100.0 * w.counters.get("moe.tokens_kept", 0) / w.counters["moe.slots_computed"]


def kernel_route_pct(pos) -> Optional[float]:
    """Percent of the registry's dispatches, forward and backward, that went
    to a ``cuda_*`` variant (the port's hand-written kernels)."""
    w = _window(pos)
    if w is None:
        return None
    routes = [(k.rsplit(".", 1)[1], v) for k, v in w.counters.items() if k.startswith("dispatch.")]
    total = sum(v for _, v in routes)
    return 100.0 * sum(v for name, v in routes if name.startswith("cuda_")) / total if total else None
