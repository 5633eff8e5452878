"""Device-time measurement on a CUDA card (``sputnik_tpu/utils/profiling.py``).

The reference times kernels with CUDA events around a warm-up and
iterations protocol. A small kernel called eagerly from Python waits on
its host, so :func:`time_ms` also replays the calls from a CUDA graph,
which leaves the host's launch cost out: that is the device time.
:func:`device_time` is the JAX package's entry point on that protocol, and
:func:`card` names the card and its power limit, which every measurement
carries.

The JAX package's ``trace_device_total`` / ``trace_device_events`` read
``jax.profiler`` traces; their ``torch.profiler`` counterpart is not
written yet (ROADMAP item 14). The port's own spans, marks and counters,
recorded while a ``torch.profiler`` session is active, are in
:mod:`sputnik_tpu_torch.utils.tracing`.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Tuple

import torch

__all__ = ["time_ms", "device_time", "card"]


def time_ms(fn: Callable[[], object], warmup: int = 10, iters: int = 100) -> Tuple[float, float]:
    """(device, call): milliseconds per call. ``device`` replays the ``iters``
    calls captured in one CUDA graph between two CUDA events, so the host's
    launch cost is left out; ``call`` times ``iters`` eager calls the same
    way, the host's cost included (a small kernel can wait on its host).
    ``fn`` must not read the device back: a CUDA graph cannot capture that."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    call = start.elapsed_time(stop) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, call


def device_time(op: Callable, *args, chain: int = 8, runs: int = 3, perturb_index: int = 0,
                perturb_mode: str = "row") -> dict:
    """Per-call seconds of ``op(*args)`` on the card, as
    ``sputnik_tpu/utils/profiling.py::device_time`` returns them:
    ``{"time_s", "timing", "wall_s"}``. ``time_s`` is :func:`time_ms`'s
    device time (10 warm-up calls, then 100 replayed from one CUDA graph
    between CUDA events; ``timing`` is ``"cuda_graph"``), ``wall_s`` its
    eager per-call time with the host's cost.

    The JAX protocol chains ``chain`` calls in one jitted executable,
    ``runs`` times, and perturbs operand ``perturb_index`` (``"row"``,
    ``"roll"`` or ``"feed"``) so that XLA can neither merge the repeated
    calls (CSE) nor cut their unused parts away (DCE). Eager PyTorch does
    neither, and the 100 graph-replayed calls take the chain's place, so
    these four arguments are accepted for the JAX signature and not used;
    an unknown ``perturb_mode`` still raises. ``op`` must not read the card
    back (a CUDA graph cannot capture that)."""
    if perturb_mode not in ("row", "roll", "feed"):
        raise ValueError(f"perturb_mode must be 'row', 'roll' or 'feed', got {perturb_mode!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA card: torch.cuda.is_available() is false")
    device_ms, call_ms = time_ms(lambda: op(*args))
    return {"time_s": device_ms * 1e-3, "timing": "cuda_graph", "wall_s": call_ms * 1e-3}


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them for
    the first card (a card below its 700 W limit runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]
