"""Spans, marks and counters recorded inside the port while a
``torch.profiler`` session is active.

The one switch is the profiler: every site reads
``torch.autograd.profiler._is_profiler_enabled`` and, when it is false,
does nothing else (no ``record_function``, no CUDA event, no autograd node,
no allocation). An operator turns tracing on by profiling the process;
the benchmark's traced run profiles exactly its window.

A span (:class:`Span`) is kept in memory with its id, its name, the span
that caused it (the enclosing span, or for a backward span its forward
span), the ``lm_generate_batched`` call it belongs to and its row where
one exists, and a start and an end :class:`Stamp`: the host time on the
profiler's own clock (``time.time_ns``, the Unix-epoch nanoseconds kineto
stamps its events with) and, on a card, a CUDA event on the current stream.
Each span also opens ``torch.profiler.record_function("sputnik.<name>")``,
so it appears in the profiler's trace (and ``export_chrome_trace``) beside
the kernels it launched, on the same clock.

The spans, by site:

* ``generate`` (``lm_generate_batched``; a new call id), ``prefill`` (one
  per row of that call), ``decode_step`` (``lm_decode_step``), ``loss``
  (``lm_loss``: a training micro-batch's forward);
* ``attention`` (``multihead_block_sparse_attention``,
  ``decode_band_attention``, ``decode_topk_attention``) and ``moe``
  (``moe_forward``, ``moe_one``, ``dropless_moe_forward``), and, where
  autograd will differentiate them, ``attention.backward`` and
  ``moe.backward``: an identity autograd node on the layer's outputs opens
  the span when their gradient arrives, one on its inputs closes it.

Marks (:class:`Mark`): ``first_token``, in ``decode_tokens`` right after
the first token of every row is sampled. Counters: host integers
(:func:`count`; ``dispatch.<op>.<variant>`` for every registry dispatch,
``moe.tokens_routed`` and ``moe.slots_computed`` in ``moe_forward``'s
capacity routing, ``tracing.spans_lost``) and device counters summed on
the card with no host read (:func:`count_device`; ``moe.tokens_kept``).

:func:`position` marks a point; :func:`since` returns the spans, marks and
counter deltas recorded after it (:class:`Window`), reading the device
counters and waiting for the card. The store keeps at most :data:`CAP`
spans and as many marks; those past it are counted in
``tracing.spans_lost``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["CAP", "Stamp", "Span", "Mark", "Position", "Window", "recording", "elapsed_ms", "span", "traced",
           "mark", "count", "count_device", "position", "since"]

CAP = 1 << 17
PREFIX = "sputnik."


def recording() -> bool:
    """Whether a profiler session is active: the switch of every site."""
    return _autograd_profiler._is_profiler_enabled


class Stamp(NamedTuple):
    """A point in time: host nanoseconds on the profiler's clock, and on a
    card a CUDA event recorded on the current stream (None on the CPU)."""

    ns: int
    event: Optional[torch.cuda.Event] = None


def _event(device: Optional[torch.device]) -> Optional[torch.cuda.Event]:
    if device is None or device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def elapsed_ms(a: Stamp, b: Stamp) -> float:
    """Device milliseconds from ``a`` to ``b``: between their CUDA events on
    a card, on the host clock on the CPU (where work runs as it is issued).
    The events must be complete, as they are after :func:`since`."""
    if a.event is not None and b.event is not None:
        return a.event.elapsed_time(b.event)
    return (b.ns - a.ns) * 1e-6


# Spans hold their stamps' fields flat, and no class here has a __dict__:
# every object the store keeps is one the garbage collector scans until it
# is old, and a profiled training step keeps hundreds of spans.
@dataclasses.dataclass(slots=True)
class Span:
    id: int
    name: str  # without the "sputnik." of the trace
    parent: Optional[int]  # the span that caused it
    call: Optional[int]  # the lm_generate_batched call
    row: Optional[int]
    start_ns: int
    start_event: Optional[torch.cuda.Event]
    end_ns: Optional[int] = None  # None while open
    end_event: Optional[torch.cuda.Event] = None

    @property
    def start(self) -> Stamp:
        return Stamp(self.start_ns, self.start_event)

    @property
    def end(self) -> Optional[Stamp]:
        return None if self.end_ns is None else Stamp(self.end_ns, self.end_event)

    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self) -> float:
        return elapsed_ms(self.start, self.end)


@dataclasses.dataclass(slots=True)
class Mark:
    id: int
    name: str
    parent: Optional[int]
    call: Optional[int]
    rows: int  # rows 0 .. rows - 1 of its call
    at: Stamp


@dataclasses.dataclass(frozen=True)
class Position:
    spans: int
    marks: int
    counts: Dict[str, int]
    device_counts: Dict[Tuple[str, torch.device], torch.Tensor]


@dataclasses.dataclass
class Window:
    """What was recorded after a :class:`Position`."""

    spans: List[Span]
    marks: List[Mark]
    counters: Dict[str, int]  # nonzero deltas, host and device counters alike


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.calls = itertools.count()
        self.spans: List[Span] = []
        self.marks: List[Mark] = []
        self.counts: Dict[str, int] = collections.Counter()
        self.device_counts: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self.local = threading.local()  # .stack: the spans open on this thread

    def stack(self) -> List[Span]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def keep(self, into: list, item) -> None:
        with self.lock:
            if len(into) < CAP:
                into.append(item)
            else:
                self.counts["tracing.spans_lost"] += 1


_STORE = _Store()


def _open(name: str, device, parent: Optional[int], call: Optional[int], row: Optional[int]):
    # The host times bracket the profiler's range as closely as they can
    # (its first entry in a process takes a millisecond); the events lie
    # inside it.
    rf = torch.profiler.record_function(PREFIX + name)
    ns = time.time_ns()
    rf.__enter__()
    s = Span(next(_STORE.ids), name, parent, call, row, ns, _event(device))
    _STORE.keep(_STORE.spans, s)
    return s, rf


def _close(s: Span, rf, device) -> None:
    s.end_event = _event(device)
    rf.__exit__(None, None, None)
    s.end_ns = time.time_ns()


class _SpanContext:
    """A span around a ``with`` block, child of the span open on this
    thread."""

    __slots__ = ("args", "span", "rf")

    def __init__(self, name, device, row, new_call):
        self.args = name, device, row, new_call

    def __enter__(self) -> Span:
        name, device, row, new_call = self.args
        stack = _STORE.stack()
        up = stack[-1] if stack else None
        call = next(_STORE.calls) if new_call else (up.call if up else None)
        self.span, self.rf = _open(name, device, up.id if up else None, call,
                                   row if row is not None else (up.row if up else None))
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc):
        _STORE.stack().pop()
        _close(self.span, self.rf, self.args[1])
        return False


_NULL = contextlib.nullcontext()


def span(name: str, device: Optional[torch.device], *, row: Optional[int] = None, new_call: bool = False):
    """A context manager: while recording, the span ``name`` around the
    block, with CUDA events when ``device`` is a card, a new call id with
    ``new_call``, else its parent's call and row; otherwise a no-op."""
    if not recording():
        return _NULL
    return _SpanContext(name, device, row, new_call)


class _Backward:
    """The backward span of one forward span: opened by the output marker,
    closed by the input marker."""

    __slots__ = ("fwd", "device", "open_span")

    def __init__(self, fwd: Span, device):
        self.fwd, self.device, self.open_span = fwd, device, None

    def open(self) -> None:
        if self.open_span is None and recording():
            f = self.fwd
            self.open_span = _open(f.name + ".backward", self.device, f.id, f.call, f.row)

    def close(self) -> None:
        if self.open_span is not None:
            _close(*self.open_span, self.device)
            self.open_span = None


class _Marker(torch.autograd.Function):
    """Identity on a layer's outputs or inputs; its gradient calls ``action``
    (opening or closing the backward span)."""

    @staticmethod
    def forward(ctx, action, *xs):
        ctx.action = action
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ctx.action()
        return (None, *grads)


def _mark_outputs(bw: _Backward, out):
    if isinstance(out, torch.Tensor):
        return _Marker.apply(bw.open, out)[0]
    at = [i for i, o in enumerate(out) if isinstance(o, torch.Tensor)]
    marked = dict(zip(at, _Marker.apply(bw.open, *(out[i] for i in at))))
    return type(out)(marked.get(i, o) for i, o in enumerate(out))


def traced(name: str, inputs: Tuple[int, ...]):
    """Decorator: while recording, the span ``name`` around each call, on
    the device of the first tensor among the positional arguments
    ``inputs``; where autograd will differentiate one of those, also the
    span ``<name>.backward``, by identity markers on them and on the
    outputs. Otherwise the call runs as it is."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            at = [i for i in inputs if i < len(args) and isinstance(args[i], torch.Tensor)]
            device = args[at[0]].device if at else None
            with _SpanContext(name, device, None, False) as s:
                if not (torch.is_grad_enabled() and any(args[i].requires_grad for i in at)):
                    return fn(*args, **kwargs)
                bw = _Backward(s, device)
                args = list(args)
                for i, x in zip(at, _Marker.apply(bw.close, *(args[i] for i in at))):
                    args[i] = x
                return _mark_outputs(bw, fn(*args, **kwargs))
        return run
    return wrap


def mark(name: str, device: Optional[torch.device], rows: int) -> None:
    """While recording, the mark ``name`` for rows ``0 .. rows - 1`` of the
    span open on this thread (its parent, whose call it takes)."""
    if not recording():
        return
    stack = _STORE.stack()
    up = stack[-1] if stack else None
    _STORE.keep(_STORE.marks, Mark(next(_STORE.ids), name, up.id if up else None, up.call if up else None, rows,
                                   Stamp(time.time_ns(), _event(device))))


def count(name: str, n: int = 1) -> None:
    """While recording, add ``n`` to the host counter ``name``."""
    if not recording():
        return
    with _STORE.lock:
        _STORE.counts[name] += n


def count_device(name: str, t: torch.Tensor) -> None:
    """While recording, add the sum of the integer or boolean tensor ``t``
    to the counter ``name`` kept on ``t``'s device, with no host read."""
    if not recording():
        return
    key = (name, t.device)
    with _STORE.lock:
        acc = _STORE.device_counts.get(key)
        if acc is None:
            acc = _STORE.device_counts[key] = torch.zeros((), dtype=torch.int64, device=t.device)
        acc.add_(t.sum())


def position() -> Position:
    """The point after everything recorded so far."""
    with _STORE.lock:
        return Position(len(_STORE.spans), len(_STORE.marks), dict(_STORE.counts),
                        {k: v.clone() for k, v in _STORE.device_counts.items()})


def since(pos: Position) -> Window:
    """The spans, marks and counter deltas recorded after ``pos``. Waits
    for the card, so that every event and device counter is complete."""
    with _STORE.lock:
        spans, marks = _STORE.spans[pos.spans:], _STORE.marks[pos.marks:]
        counts, device_counts = dict(_STORE.counts), dict(_STORE.device_counts)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    deltas = collections.Counter({k: v - pos.counts.get(k, 0) for k, v in counts.items()})
    for (name, dev), acc in device_counts.items():
        before = pos.device_counts.get((name, dev))
        deltas[name] += int(acc.item()) - (0 if before is None else int(before.item()))
    return Window(spans, marks, {k: v for k, v in deltas.items() if v})
