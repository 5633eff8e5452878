"""Mellum2's weights, made by the benchmark from ``--seed``, as
``weights.py`` makes the sparse LM's: every leaf of the port's
``state_dict`` drawn on its own generator, seeded from the run's seed and
the leaf's name, so the plain reference draws the same values afresh.
Scales: normal / sqrt(fan-in), RMSNorm weights at 1. Plain ``torch`` only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import weights


def leaf_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], torch.dtype, Tuple]]:
    """(name, shape, storage dtype, init) of every leaf: ``wqkv`` (d, (H +
    2 H_kv) dh) with q, k, v in that order; ``moe.w13`` (d, E 2F) with
    each expert's gate columns, then its up columns; ``moe.w2`` (E F, d);
    an untied ``lm_head`` (vocab, d)."""
    d, v, e, f = cfg["hidden_size"], cfg["vocab_size"], cfg["num_experts"], cfg["moe_intermediate_size"]
    h, hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    low = weights.DTYPES[cfg["dtype"]]
    fp32 = set(cfg["fp32_leaves"])
    s = 1.0 / math.sqrt(d)

    def dt(short):
        return torch.float32 if short in fp32 else low

    specs = [("embed", (v, d), low, ("normal", s)), ("lnf_scale", (d,), torch.float32, ("ones",)),
             ("lm_head", (v, d), low, ("normal", s))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        specs += [
            (p + "wqkv", (d, (h + 2 * hkv) * dh), dt("wqkv"), ("normal", s)),
            (p + "wo", (h * dh, d), dt("wo"), ("normal", 1.0 / math.sqrt(h * dh))),
            (p + "ln1_scale", (d,), torch.float32, ("ones",)),
            (p + "ln2_scale", (d,), torch.float32, ("ones",)),
            (p + "moe.router", (d, e), dt("moe.router"), ("normal", s)),
            (p + "moe.w13", (d, 2 * e * f), dt("moe.w13"), ("normal", s)),
            (p + "moe.w2", (e * f, d), dt("moe.w2"), ("normal", 1.0 / math.sqrt(f))),
        ]
    return specs


def draw(cfg: Dict, seed: int, name: str, device) -> torch.Tensor:
    """Leaf ``name`` in its storage dtype, drawn afresh on ``device``."""
    for n, shape, dtype, init in leaf_specs(cfg):
        if n == name:
            return weights._fill(torch.empty(shape, dtype=dtype, device=device), n, init, seed)
    raise KeyError(name)


@torch.no_grad()
def fill_module(module: torch.nn.Module, cfg: Dict, seed: int) -> None:
    """Fill a module whose parameters are exactly :func:`leaf_specs`'s in
    place, each with the values :func:`draw` gives."""
    params = dict(module.named_parameters())
    specs = leaf_specs(cfg)
    if sorted(params) != sorted(n for n, *_ in specs):
        raise ValueError("the model's parameters are not the configuration's leaves: "
                         f"{sorted(set(params) ^ {n for n, *_ in specs})}")
    for n, shape, dtype, init in specs:
        p = params[n]
        if tuple(p.shape) != shape or p.dtype != dtype or not p.is_contiguous():
            raise ValueError(f"{n}: the model holds {tuple(p.shape)} {p.dtype}, the configuration {shape} {dtype}")
        weights._fill(p.data, n, init, seed)
