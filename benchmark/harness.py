"""Runs one cell of ``BENCHMARK.json`` once and builds its result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``configs/<config>.json``, ``traffic/<traffic>.json``
(whose ``driver`` names ``drivers/<driver>.py``), ``limits/<workload>.json``
and ``metrics/<metric>.py``. A metric module defines ``read(reading)``,
returning a number or None (nothing to read: the metric is left out of the
line), and may list in ``RANGES`` the port functions (``module:function``)
its reading needs wrapped in the traced run.

On the card a run notes the host it ran on (CPU, affinity, load, the
card's ``local_cpulist`` and how many of its CPUs the affinity holds, and
the time a fixed Python loop takes before set-up and after the window), so
that a slow host can be told from a slow program. It changes nothing of
where it runs.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set

import torch


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int


def cell(root: Path, workload: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    bench = root / "benchmark"
    cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])

    def applies(metric):
        return workload in metric.get("workloads", [w["name"] for w in spec["workloads"]])

    return Cell(
        name=workload,
        config=load_json(root / cfg["file"]),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
        chips=entry["chips"],
    )


def metric_module(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def transformer_config(cfg: Dict):
    from sputnik_tpu_torch.models.transformer import TransformerConfig
    from benchmark.weights import DTYPES
    return TransformerConfig(
        d_model=cfg["d_model"], n_heads=cfg["n_heads"], seq_len=cfg["seq_len"],
        window_blocks=cfg["window_blocks"], n_experts=cfg["n_experts"], d_ff=cfg["d_ff"],
        capacity=cfg["capacity"], n_layers=cfg["n_layers"], vocab=cfg["vocab"],
        dtype=DTYPES[cfg["dtype"]], fused_attention=cfg["fused_attention"],
    )


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# Top-level modules that no run may hold once its window has closed: JAX and
# the JAX package, of which the port is a translation.
FORBIDDEN = ("jax", "jaxlib", "flax", "sputnik_tpu")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_cpulist(text: str) -> Set[int]:
    """The CPUs of a sysfs cpulist such as ``0-31,64-95``."""
    cpus: Set[int] = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def placement(text: Optional[str], where: str) -> str:
    """Says where the card's local CPUs are and how many of them this
    process may run on, from the text of sysfs' ``local_cpulist`` (None
    where the file is missing)."""
    if text is None:
        return f"card local_cpulist missing ({where})"
    local = parse_cpulist(text)
    if not local:
        return f"card local_cpulist empty ({where})"
    return (f"card local_cpulist {text.strip()!r}, {len(local & os.sched_getaffinity(0))} of its "
            f"{len(local)} CPUs in the affinity")


def host_loop_ms(repeats: int = 5) -> float:
    """The median time of a fixed pure-Python loop, in ms: how fast the host
    runs one thread now."""
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        s = 0
        for i in range(20000):
            s += i * i % 7
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def host_facts(placed: str) -> str:
    def first(path: str, prefix: str = "") -> str:
        try:
            with open(path) as fh:
                for line in fh:
                    if line.startswith(prefix):
                        return line.split(":", 1)[1].strip() if prefix else line.strip()
        except OSError:
            pass
        return "unknown"
    return (f"cpu {first('/proc/cpuinfo', 'model name')}, {len(os.sched_getaffinity(0))} CPUs in the affinity "
            f"of {os.cpu_count()}, loadavg {first('/proc/loadavg')}, {placed}")


class Variants:
    """Records the registry variant each op dispatches to while installed."""

    def __init__(self):
        from sputnik_tpu_torch.ops import registry
        self._registry = registry
        self._select = registry._select
        self.seen: Dict[str, set] = {}

        def select(op, args, kwargs, variant=None):
            v = self._select(op, args, kwargs, variant)
            self.seen.setdefault(op, set()).add(v.name)
            return v

        registry._select = select

    def restore(self) -> Dict[str, List[str]]:
        self._registry._select = self._select
        return {op: sorted(names) for op, names in sorted(self.seen.items())}


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, and the hooks of
    the traced run."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    ranges: Any = None  # trace.Ranges in the traced run
    # Called by the driver right after the window, while the program's state
    # is live: reads the per-layer metrics.
    after_window: Callable[["Outcome"], None] = lambda outcome: None

    def traced(self):
        """The profiler over the traced window, or a no-op."""
        if not self.trace:
            return _Null()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def window(self):
        from benchmark.trace import WINDOW
        return torch.profiler.record_function(WINDOW) if self.trace else _Null()


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, float]  # name -> reading, held against the cell's limits
    memory_peak_bytes: int
    work: Dict[str, Any]  # what the traced window computed, for the readers
    prof: Any = None
    notes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reads."""

    config: Dict
    profile: Any  # trace.Profile or None
    ranges: Any  # trace.Ranges or None
    work: Dict[str, Any]


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Dict:
    from benchmark import trace as trace_lib
    c = cell(root, workload)
    metrics = {m["name"]: metric_module(root, m["name"]) for m in c.per_layer} if trace else {}
    specs = sorted({s for mod in metrics.values() for s in getattr(mod, "RANGES", [])})
    ranges = trace_lib.Ranges(specs, cuda=device.type == "cuda") if trace else None
    driver = importlib.import_module(f"benchmark.drivers.{c.traffic['driver']}")
    values: Dict[str, Dict] = {}
    profile = []

    def after_window(out: Outcome) -> None:
        if not trace:
            for m in c.end_to_end:
                values[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
            return
        ranges.restore()
        for spec in ranges.missing:
            log(f"range {spec} no longer exists: the metrics that read it are left out")
        prof = trace_lib.read_profile(out.prof, [trace_lib.range_name(s) for s in specs]) if out.prof else None
        profile.append(prof)
        reading = Reading(config=c.config, profile=prof, ranges=ranges, work=out.work)
        for name, mod in metrics.items():
            v = mod.read(reading)
            if v is None:
                log(f"metric {name}: nothing to read, left out")
                continue
            values[name] = {"value": v, "unit": next(m["unit"] for m in c.per_layer if m["name"] == name)}
        ranges.calls = []

    host = []
    if device.type == "cuda":
        p = torch.cuda.get_device_properties(device)
        path = Path(f"/sys/bus/pci/devices/{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"
                    "/local_cpulist")
        try:
            text = path.read_text()
        except OSError:
            text = None
        host.append(host_facts(placement(text, str(path))))
    loop_ms = [host_loop_ms()]

    def window_closed(out: Outcome) -> None:
        loop_ms.append(host_loop_ms())
        after_window(out)

    ctx = Context(cell=c, seed=seed, seconds=seconds, trace=trace, device=device,
                  t_start=t_start, ranges=ranges, after_window=window_closed)
    try:
        out = driver.run(ctx)
    finally:
        if ranges is not None:
            ranges.restore()
    host.append(f"a fixed Python loop took {loop_ms[0]:.3f} ms before set-up, {loop_ms[-1]:.3f} ms after the window")
    prof = profile[0] if profile else None
    checks = {}
    correct = out.failed == 0
    for name, value in out.checks.items():
        limit = c.limits[name]
        checks[name] = {"value": value, "limit": limit}
        correct = correct and math.isfinite(value) and value <= limit
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed, "metrics": values,
              "device": _device(device, c.chips, out.memory_peak_bytes, prof)}
    if prof is not None:
        result["breakdown"] = {"device_ops": prof.device_ops, "idle_gaps": prof.idle_gaps}
    result["checks"] = checks
    if device.type == "cuda":
        from sputnik_tpu_torch.utils.profiling import card
        host.insert(0, card())
    log(("card: " if device.type == "cuda" else "host: ") + "; ".join(host))
    for note in out.notes:
        log(note)
    return result


def _device(device: torch.device, chips: int, peak: int, profile) -> Dict:
    if device.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1}
    d["memory_peak_bytes"] = int(peak)
    if profile is not None:
        d["busy_s"] = profile.busy_s
        d["window_s"] = profile.window_s
    return d


def now() -> float:
    return time.perf_counter()
