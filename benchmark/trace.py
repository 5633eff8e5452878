"""Layer ranges and the device trace of a ``--trace 1`` run.

The port has no spans of its own, so the benchmark wraps the port's layer
functions by name, in the traced run only, in ``torch.profiler``
``record_function`` ranges with a CUDA event pair around each call
(:class:`Ranges`). :func:`read_profile` reduces the profiler's events to
device time under each range, the device's busy time in the traced window,
and the breakdown the result line carries.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import importlib
from typing import Any, Dict, List, Optional, Tuple

import torch

# Activity types of work on the device (kineto's names).
DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset", "concurrent kernel"}
WINDOW = "bench.window"


def range_name(spec: str) -> str:
    """``sputnik_tpu_torch.models.moe:moe_one`` -> ``moe.moe_one``."""
    module, fn = spec.split(":")
    return f"{module.rsplit('.', 1)[-1]}.{fn}"


@dataclasses.dataclass
class Call:
    name: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    start: Optional[torch.cuda.Event]
    end: Optional[torch.cuda.Event]

    def ms(self) -> Optional[float]:
        return None if self.start is None else self.start.elapsed_time(self.end)


def _detach(a):
    return a.detach() if isinstance(a, torch.Tensor) else a


class Ranges:
    """Wraps each ``module:function`` of ``specs`` in a ``record_function``
    range named by :func:`range_name`, and records every call (its
    arguments, detached, and a CUDA event pair on the card) while
    ``recording``. ``missing`` lists the specs that no longer exist."""

    def __init__(self, specs, cuda: bool):
        self.calls: List[Call] = []
        self.missing: List[str] = []
        self.recording = False
        self._cuda = cuda
        self._saved = []
        for spec in sorted(set(specs)):
            module_name, fn_name = spec.split(":")
            module = importlib.import_module(module_name)
            fn = getattr(module, fn_name, None)
            if fn is None:
                self.missing.append(spec)
                continue
            self._saved.append((module, fn_name, fn))
            setattr(module, fn_name, self._wrap(range_name(spec), fn))

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            if not self.recording:
                return fn(*args, **kwargs)
            start = end = None
            with torch.profiler.record_function(name):
                if self._cuda:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                out = fn(*args, **kwargs)
                if self._cuda:
                    end.record()
            self.calls.append(Call(name, tuple(_detach(a) for a in args),
                                   {k: _detach(v) for k, v in kwargs.items()}, start, end))
            return out
        wrapped.__wrapped__ = fn
        return wrapped

    def restore(self):
        for module, fn_name, fn in self._saved:
            setattr(module, fn_name, fn)
        self._saved = []

    def of(self, name: str) -> List[Call]:
        return [c for c in self.calls if c.name == name]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Profile:
    window_s: float
    busy_s: float
    range_device_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def read_profile(prof, range_names) -> Optional[Profile]:
    """Reduce a finished ``torch.profiler.profile`` whose traced work sits
    inside a ``record_function(WINDOW)`` range. Device time under a range is
    the summed duration of the device work launched by CPU ops that started
    inside that range (on any thread); busy time is the union of device
    work inside the window. None when the trace holds no device work."""
    events = prof.profiler.kineto_results.events()
    names = set(range_names) | {WINDOW}
    ranges = collections.defaultdict(list)
    cpu_ops = {}
    device = []
    for e in events:
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() in names and e.is_user_annotation():
                ranges[e.name()].append((e.start_ns(), e.end_ns()))
            elif kind in ("cpu_op", "") and not e.is_user_annotation():
                cpu_ops[e.correlation_id()] = (e.name(), e.start_ns())
        elif kind in DEVICE_ACTIVITIES or (not kind and not e.is_user_annotation() and e.name() not in names):
            device.append((e.start_ns(), e.end_ns(), e.name(), e.linked_correlation_id()))
    if not device or not ranges[WINDOW]:
        return None
    w0, w1 = ranges[WINDOW][0]
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    if not device:
        return None
    sorted_ranges = {n: sorted(iv) for n, iv in ranges.items()}
    starts = {n: [s for s, _ in iv] for n, iv in sorted_ranges.items()}

    def inside(name, t):
        iv = sorted_ranges.get(name, [])
        k = bisect.bisect_right(starts.get(name, []), t) - 1
        return k >= 0 and iv[k][0] <= t <= iv[k][1]

    range_s = collections.defaultdict(float)
    by_op = collections.defaultdict(float)
    launched_by = []
    for s, e, name, corr in device:
        dur = (min(e, w1) - max(s, w0)) * 1e-9
        by_op[name] += dur
        op = cpu_ops.get(corr)
        label = "unknown"
        if op is not None:
            enclosing = [n for n in range_names if inside(n, op[1])]
            for n in enclosing:
                range_s[n] += dur
            label = op[0] if not enclosing else f"{enclosing[-1]}/{op[0]}"
        launched_by.append((s, label))
    merged = _merge([(max(s, w0), min(e, w1)) for s, e, _, _ in device])
    busy = sum(e - s for s, e in merged) * 1e-9
    # An idle gap is named by the host work that launched the device work
    # ending it.
    launched_by.sort()
    first_start = [s for s, _ in launched_by]
    gaps = collections.defaultdict(float)
    prev_end = w0
    for s, e in merged:
        if s > prev_end:
            k = bisect.bisect_left(first_start, s)
            gaps[launched_by[k][1] if k < len(launched_by) else "unknown"] += (s - prev_end) * 1e-9
        prev_end = e
    if w1 > prev_end:
        gaps["window end"] += (w1 - prev_end) * 1e-9
    def top(d):
        # Names cut to 160 characters: a kernel's C++ name runs to thousands.
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Profile(window_s=(w1 - w0) * 1e-9, busy_s=busy, range_device_s=dict(range_s),
                   device_ops=top(by_op), idle_gaps=top(gaps))
