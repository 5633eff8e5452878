"""Device-time measurement on a CUDA card (``sputnik_tpu/utils/profiling.py``).

The reference times kernels with CUDA events around a warm-up and
iterations protocol. A small kernel called eagerly from Python waits on
its host, so :func:`time_ms` also replays the calls from a CUDA graph,
which leaves the host's launch cost out: that is the device time.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["time_ms"]


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
