"""The model's weights, made by the benchmark from ``--seed``.

Every leaf of the sparse LM's ``state_dict`` is drawn on its own
``torch.Generator``, seeded from the run's seed and the leaf's name, so any
leaf can be drawn again alone: the program's parameters are filled in
place, and the plain reference draws the same values afresh after the
window (it takes nothing the program holds). Scales are the port's:
normal / sqrt(fan-in), layernorms at 1 and 0. Plain ``torch`` only.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def derive(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed and a name."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(derive(seed, name))
    return g


def leaf_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], torch.dtype, Tuple]]:
    """(name, shape, storage dtype, init) of every leaf, in ``state_dict``
    order; init is ("normal", std), ("ones",) or ("zeros",)."""
    d, e, f, v = cfg["d_model"], cfg["n_experts"], cfg["d_ff"], cfg["vocab"]
    low = DTYPES[cfg["dtype"]]
    fp32 = set(cfg["fp32_leaves"])
    s = 1.0 / math.sqrt(d)

    def dt(short):
        return torch.float32 if short in fp32 else low

    specs = [("embed", (v, d), low, ("normal", s))]
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."
        specs += [
            (p + "wqkv", (d, 3 * d), dt("wqkv"), ("normal", s)),
            (p + "wo", (d, d), dt("wo"), ("normal", s)),
            (p + "ln1_scale", (d,), dt("ln1_scale"), ("ones",)),
            (p + "ln1_bias", (d,), dt("ln1_bias"), ("zeros",)),
            (p + "ln2_scale", (d,), dt("ln2_scale"), ("ones",)),
            (p + "ln2_bias", (d,), dt("ln2_bias"), ("zeros",)),
            (p + "moe.router", (d, e), dt("moe.router"), ("normal", s)),
            (p + "moe.w1", (d, e * f), dt("moe.w1"), ("normal", s)),
            (p + "moe.w2", (e * f, d), dt("moe.w2"), ("normal", 1.0 / math.sqrt(f))),
        ]
    specs += [("lnf_scale", (d,), dt("lnf_scale"), ("ones",)), ("lnf_bias", (d,), dt("lnf_bias"), ("zeros",))]
    return specs


def _fill(t: torch.Tensor, name: str, init, seed: int) -> torch.Tensor:
    if init[0] == "normal":
        t.normal_(0.0, init[1], generator=generator(seed, "w:" + name, t.device))
    elif init[0] == "ones":
        t.fill_(1.0)
    else:
        t.zero_()
    return t


def draw(cfg: Dict, seed: int, name: str, device) -> torch.Tensor:
    """Leaf ``name`` in its storage dtype, drawn afresh on ``device``."""
    for n, shape, dtype, init in leaf_specs(cfg):
        if n == name:
            return _fill(torch.empty(shape, dtype=dtype, device=device), n, init, seed)
    raise KeyError(name)


def draw_all(cfg: Dict, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every leaf, one at a time, in ``state_dict`` order."""
    for n, shape, dtype, init in leaf_specs(cfg):
        yield n, _fill(torch.empty(shape, dtype=dtype, device=device), n, init, seed)


@torch.no_grad()
def fill_module(module: torch.nn.Module, cfg: Dict, seed: int) -> None:
    """Fill a module whose ``state_dict`` has exactly the leaves of
    :func:`leaf_specs` in place, each with the values :func:`draw` gives."""
    params = dict(module.named_parameters())
    specs = leaf_specs(cfg)
    if sorted(params) != sorted(n for n, *_ in specs):
        raise ValueError("the model's parameters are not the configuration's leaves: "
                         f"{sorted(set(params) ^ {n for n, *_ in specs})}")
    for n, shape, dtype, init in specs:
        p = params[n]
        if tuple(p.shape) != shape or p.dtype != dtype or not p.is_contiguous():
            raise ValueError(f"{n}: the model holds {tuple(p.shape)} {p.dtype}, the configuration {shape} {dtype}")
        _fill(p.data, n, init, seed)
