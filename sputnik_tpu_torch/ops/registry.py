"""Kernel-variant registry with ``can_implement`` first-fit dispatch.

Port of ``sputnik_tpu/ops/registry.py``: per op, an ordered list of
``(can_implement, launch)`` pairs; dispatch launches the first variant that
can implement the problem, ``variant=`` picks one by name, and a problem no
variant takes raises ``NotImplementedError`` with the shapes.

:func:`forced_variant` makes every dispatch inside a ``with`` block use one
named variant, so a whole model can run on the plain versions to be
compared with its kernels.

The precedence: ``variant=``, then :func:`forced_variant`, then the
autotune cache (``ops/autotune.py``: the tuned winner for the problem's
signature, passed over when its ``can_implement`` refuses the problem),
then first fit. With an empty cache no signature is computed.

While a ``torch.profiler`` session is active, every dispatch adds one to
the host counter ``dispatch.<op>.<variant>`` (:func:`count_route`,
``utils/tracing.py``). Variants named ``cuda_*`` launch the port's
hand-written kernels; no other variant does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import logging
from typing import Callable, Dict, List, Optional

from sputnik_tpu_torch.utils import tracing

__all__ = ["KernelVariant", "register", "dispatch", "dispatch_name", "first_fit_name", "forced_variant",
           "variants_for", "count_route"]

# Enable with logging.getLogger("sputnik_tpu_torch").setLevel(logging.DEBUG).
log = logging.getLogger("sputnik_tpu_torch")


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    name: str
    can_implement: Callable[..., bool]
    launch: Callable


_REGISTRY: Dict[str, List[KernelVariant]] = {}
_FORCED: List[str] = []  # innermost forced_variant() name last
_AUTOTUNE = None


def _autotune():
    """The autotune module, imported on first dispatch (``ops`` re-exports
    a function ``autotune`` that shadows the module's name)."""
    global _AUTOTUNE
    if _AUTOTUNE is None:
        _AUTOTUNE = importlib.import_module("sputnik_tpu_torch.ops.autotune")
    return _AUTOTUNE


def register(op: str, name: str, can_implement, launch) -> KernelVariant:
    v = KernelVariant(name=name, can_implement=can_implement, launch=launch)
    _REGISTRY.setdefault(op, []).append(v)
    return v


def variants_for(op: str) -> List[KernelVariant]:
    return list(_REGISTRY.get(op, []))


@contextlib.contextmanager
def forced_variant(name: str):
    """Dispatch every op to the variant called ``name`` inside the block
    (an explicit ``variant=`` argument still wins)."""
    _FORCED.append(name)
    try:
        yield
    finally:
        _FORCED.pop()


def _select(op: str, args, kwargs, variant: Optional[str] = None) -> KernelVariant:
    variants = _REGISTRY.get(op, [])
    if variant is None and _FORCED:
        variant = _FORCED[-1]
    if variant is not None:
        for v in variants:
            if v.name == variant:
                return v
        raise ValueError(f"{op}: no variant named {variant!r}")
    tuned = _autotune().cached_variant(op, args, kwargs)
    if tuned is not None:
        for v in variants:
            if v.name == tuned:
                try:
                    ok = v.can_implement(*args, **kwargs)
                except Exception:
                    ok = False
                if ok:
                    log.debug("%s: dispatching tuned %s", op, tuned)
                    return v
                break
    return _first_fit(op, variants, args, kwargs)


def _first_fit(op: str, variants, args, kwargs) -> KernelVariant:
    for v in variants:
        if v.can_implement(*args, **kwargs):
            if log.isEnabledFor(logging.DEBUG):
                log.debug("%s: dispatching %s (shapes=%s)", op, v.name,
                          [tuple(getattr(a, "shape", ())) for a in args])
            return v
    shapes = [getattr(a, "shape", None) for a in args]
    devices = [str(getattr(a, "device", None)) for a in args]
    raise NotImplementedError(
        f"{op}: no registered kernel variant can implement the problem; "
        f"arg shapes={shapes}, devices={devices}, "
        f"kwargs={ {k: v for k, v in kwargs.items() if not hasattr(v, 'shape')} }, "
        f"variants tried={[v.name for v in variants]}"
    )


def count_route(op: str, name: str) -> None:
    """While a profiler is active, count one dispatch of ``op`` to the
    variant ``name`` in the host counter ``dispatch.<op>.<name>``
    (``utils/tracing.py``)."""
    if tracing.recording():
        tracing.count(f"dispatch.{op}.{name}")


def dispatch(op: str, *args, variant: Optional[str] = None, **kwargs):
    v = _select(op, args, kwargs, variant)
    count_route(op, v.name)
    return v.launch(*args, **kwargs)


def dispatch_name(op: str, *args, variant: Optional[str] = None, **kwargs) -> str:
    """Name of the variant :func:`dispatch` would pick, without launching."""
    return _select(op, args, kwargs, variant).name


def first_fit_name(op: str, *args, **kwargs) -> str:
    """Name of the first variant that can implement the problem, whatever
    the autotune cache holds (what ``bench.dsd --no-tune`` measures)."""
    return _first_fit(op, _REGISTRY.get(op, []), args, kwargs).name
