"""Measure-and-pick autotuning over registry variants
(``sputnik_tpu/ops/autotune.py``).

    variant = autotune("dsd", a, b)           # -> best variant name
    out = ops.matmul_dsd(a, b)                # dispatch consults the cache

:func:`benchmark_variants` times every variant whose ``can_implement``
takes the problem, on the operands given (``utils/profiling.py::
device_time``: 100 calls replayed from a CUDA graph); :func:`autotune`
keeps the fastest for the problem's signature, and ``registry.dispatch``
consults that cache before first fit, so the winner is picked with no
``variant=``. For a problem on the card the plain variants
(:data:`PLAIN_VARIANTS`) are neither timed nor kept, and a variant whose
launch raises stops the tuning (the JAX package's skips it): a kernel that
fails to build never hands a card problem to a plain version.

The cache persists at ``$SPUTNIK_TPU_TORCH_TUNE_CACHE``, or
``~/.cache/sputnik_tpu_torch/autotune.json`` (never the JAX package's
file). It is read once per process (:func:`_reset` makes the next use read
it again), versioned by ``sputnik_tpu_torch.__version__`` (a cache written
by another version is discarded on load) and keyed by the card
(``torch.cuda.get_device_name()`` for problems on the card, ``"cpu"``
otherwise), the op and the problem's signature. Tuning runs kernels: do it
once at set-up, not inside a training step.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from sputnik_tpu_torch.ops import registry

__all__ = ["PLAIN_VARIANTS", "autotune", "benchmark_variants", "cached_variant", "clear_cache"]

# The variants that compute a problem with no kernel of the port: the
# near-dense dense product, the densify detour and the CPU's plain version.
PLAIN_VARIANTS = frozenset({"xla_dense_detour", "jnp_fallback", "torch_reference"})

_CACHE: Optional[Dict[str, str]] = None  # signature -> winner, read from disk on first use
_CACHE_PATH: Optional[str] = None  # the file _CACHE was read from and is saved to
_HOT: Dict[tuple, Optional[str]] = {}  # problem key -> winner: a dispatch seen before builds no string
_CHIPS: Dict[torch.device, str] = {}


def _cache_version() -> str:
    from sputnik_tpu_torch import __version__

    return __version__


def _cache_path() -> str:
    return os.environ.get(
        "SPUTNIK_TPU_TORCH_TUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "sputnik_tpu_torch", "autotune.json"),
    )


def _reset() -> None:
    """Forget the loaded cache: the next use reads the file the environment
    names then, as a new process would."""
    global _CACHE, _CACHE_PATH
    _CACHE = _CACHE_PATH = None
    _HOT.clear()


def _load_cache() -> Dict[str, str]:
    """The entries of the cache file when it was written by this version,
    else none (a missing, unreadable or foreign file is an empty cache)."""
    global _CACHE, _CACHE_PATH
    if _CACHE is None:
        _HOT.clear()
        _CACHE_PATH = _cache_path()
        try:
            with open(_CACHE_PATH) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            raw = None
        ok = isinstance(raw, dict) and raw.get("version") == _cache_version() and isinstance(raw.get("entries"), dict)
        _CACHE = dict(raw["entries"]) if ok else {}
    return _CACHE


def _save_cache() -> None:
    entries = _load_cache()
    _HOT.clear()
    try:
        os.makedirs(os.path.dirname(_CACHE_PATH), exist_ok=True)
        with open(_CACHE_PATH, "w") as f:
            json.dump({"version": _cache_version(), "entries": entries}, f, indent=1, sort_keys=True)
    except OSError:
        pass  # a read-only file system: the cache stays in this process


def _device_of(args) -> Optional[torch.device]:
    for a in args:
        t = getattr(a, "data", a)
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def _chip(device: Optional[torch.device]) -> str:
    """The cache's card key: the CUDA card's name, else "cpu"."""
    if device is None or device.type != "cuda":
        return "cpu"
    if device not in _CHIPS:
        _CHIPS[device] = torch.cuda.get_device_name(device)
    return _CHIPS[device]


# Known dispatch kwargs and their defaults: a kwarg is dropped from the
# signature when its value equals its own default, so an explicit default and
# an absent one key alike. Unknown kwargs are kept unless None.
_SIGNATURE_DEFAULTS = {
    "transpose_a": False,
    "transpose_b": False,
    "out_dtype": None,
    "schedule": None,
    "plan": None,
    "precision": None,
    "scale": None,
}


def _key(op: str, args, kwargs) -> tuple:
    """The problem as a tuple: the card, the op, each operand's (type,
    shape, dtype, block size, nnz) and the kwargs that differ from their
    defaults."""
    sig = [_chip(_device_of(args)), op]
    for a in args:
        shape = tuple(a.shape) if getattr(a, "shape", None) is not None else None
        bs = getattr(a, "block_size", None)
        nnz = getattr(a, "nnz_blocks", None) or getattr(a, "nnz", None)
        sig.append((type(a).__name__, shape, str(getattr(a, "dtype", None)), bs, nnz))
    for k in sorted(kwargs):
        v = kwargs[k]
        if k in _SIGNATURE_DEFAULTS:
            if v is _SIGNATURE_DEFAULTS[k] or v == _SIGNATURE_DEFAULTS[k]:
                continue
        elif v is None:
            continue
        if isinstance(v, (bool, int, float, str)):
            sig.append((k, v))
        elif isinstance(v, torch.dtype):
            sig.append((k, str(v)))
    return tuple(sig)


def _signature(op: str, args, kwargs) -> str:
    """The cache file's key for the problem: :func:`_key` joined by "|"."""
    return "|".join(map(str, _key(op, args, kwargs)))


def cached_variant(op: str, args, kwargs) -> Optional[str]:
    """The tuned winner for this problem's signature, or None. Reads the
    cache only, and returns at once when it is empty, so that untuned
    dispatch computes no signature; a problem seen before is looked up by
    its key tuple, with no string built."""
    cache = _load_cache()
    if not cache:
        return None
    key = _key(op, args, kwargs)
    if key not in _HOT:
        _HOT[key] = cache.get("|".join(map(str, key)))
    return _HOT[key]


def benchmark_variants(op: str, *args, **kwargs) -> Dict[str, float]:
    """Seconds per call of every variant of ``op`` whose ``can_implement``
    takes the problem, the plain variants left out for a problem on the
    card; a predicate or a launch that raises propagates. The sparse
    operands' metadata is closed over (only their data pass through the
    timed call), as JAX's does so that host-planned variants see their host
    plans."""
    from sputnik_tpu_torch.formats import BlockSparseMatrix
    from sputnik_tpu_torch.utils.profiling import device_time

    on_card = _chip(_device_of(args)) != "cpu"
    datas = [x.data if isinstance(x, BlockSparseMatrix) else x for x in args]
    rebuilds = [(lambda d, x=x: x.with_data(d)) if isinstance(x, BlockSparseMatrix) else (lambda d: d)
                for x in args]
    timings = {}
    for v in registry.variants_for(op):
        if (on_card and v.name in PLAIN_VARIANTS) or not v.can_implement(*args, **kwargs):
            continue

        def run(*a, _launch=v.launch):
            out = _launch(*[rb(ai) for rb, ai in zip(rebuilds, a)], **kwargs)
            return out.data if isinstance(out, BlockSparseMatrix) else out

        timings[v.name] = device_time(run, *datas)["time_s"]
    return timings


def autotune(op: str, *args, timings: Optional[dict] = None, **kwargs) -> str:
    """The fastest variant for this problem, cached by card and signature
    and persisted; later dispatches pick it. ``timings`` (a
    :func:`benchmark_variants` result) persists a winner without measuring
    again. A plain variant cannot win a problem on the card: it raises."""
    cache = _load_cache()
    key = _signature(op, args, kwargs)
    if key in cache:
        return cache[key]
    if timings is None:
        timings = benchmark_variants(op, *args, **kwargs)
    if not timings:
        raise NotImplementedError(
            f"{op}: no variant can implement this problem (tried {[v.name for v in registry.variants_for(op)]})"
        )
    best = min(timings, key=timings.get)
    if best in PLAIN_VARIANTS and _chip(_device_of(args)) != "cpu":
        raise ValueError(f"{op}: the plain variant {best} would win a problem on the card: {timings}")
    cache[key] = best
    _save_cache()
    return best


def clear_cache(*, all_chips: bool = False) -> None:
    """Drop the tuned entries of this machine's card (its CUDA card, else
    "cpu"); entries of other cards in the shared file stay.
    ``all_chips=True`` removes the whole file."""
    cache = _load_cache()
    if all_chips:
        cache.clear()
        _HOT.clear()
        try:
            os.remove(_CACHE_PATH)
        except OSError:
            pass
        return
    prefix = _chip(torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None) + "|"
    for k in [k for k in cache if k.startswith(prefix)]:
        del cache[k]
    _save_cache()
