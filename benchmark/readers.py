"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).

Each returns None where the traced run holds nothing to read, never 0 for
a share of a roofline or a peak.
"""

from __future__ import annotations

import statistics
from typing import Optional

import torch

from benchmark import flops
from benchmark.trace import range_name as _range

ATTENTION = "sputnik_tpu_torch.models.attention:multihead_block_sparse_attention"
MOE = ("sputnik_tpu_torch.models.moe:moe_forward", "sputnik_tpu_torch.models.moe:dropless_moe_forward",
       "sputnik_tpu_torch.models.moe:moe_one")
PREFILL = "sputnik_tpu_torch.models.transformer:lm_prefill"
DECODE = "sputnik_tpu_torch.models.transformer:lm_decode_step"


def _experts_chosen(call, cfg) -> int:
    """Distinct experts a decode step's tokens chose (the port's routing:
    top-1 of the fp32 product of bf16-rounded operands)."""
    params, x = call.args[0], call.args[1]
    d = cfg["d_model"]
    with torch.no_grad():
        xt = x.reshape(-1, d).to(torch.bfloat16).float()
        e = (xt @ params.router.detach().to(torch.bfloat16).float()).argmax(dim=-1)
    return int(torch.unique(e).numel())


def _least(call, cfg) -> float:
    name = call.name
    if name == _range(ATTENTION):
        return flops.least_time(*flops.attention(cfg, call.args[0].shape[-2]))
    if name == _range(MOE[2]):
        n = call.args[1].reshape(-1, cfg["d_model"]).shape[0]
        return flops.least_time(*flops.moe(cfg, n, _experts_chosen(call, cfg)))
    return flops.least_time(*flops.moe(cfg, call.args[1].shape[0]))


def roofline(r, specs) -> Optional[float]:
    """Percent: the summed least time of the layer's calls over the device
    time under its ranges."""
    if r.profile is None or r.ranges is None:
        return None
    names = [_range(s) for s in specs]
    calls = [c for c in r.ranges.calls if c.name in names]
    device_s = sum(r.profile.range_device_s.get(n, 0.0) for n in names)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(_least(c, r.config) for c in calls) / device_s


def idle_pct(r) -> Optional[float]:
    if r.profile is None or r.profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.profile.busy_s / r.profile.window_s)


def mfu(r) -> Optional[float]:
    """Percent: the traced window's useful operations over the window at the
    bf16 peak."""
    if r.profile is None or r.profile.window_s <= 0:
        return None
    cfg, w = r.config, r.work
    if "train_sequences" in w:
        useful = w["train_sequences"] * flops.train_sequence(cfg, w["seq_len"])
    else:
        useful = sum(flops.prefill(cfg, tp) for tp in w["prefill"]) + \
            sum(flops.decode_step(cfg, b, pos) for b, pos in w["decode"])
    if useful <= 0:
        return None
    return 100.0 * useful / (r.profile.window_s * flops.PEAK_BF16_FLOPS)


def median_ms(r, spec) -> Optional[float]:
    """Median of the CUDA-event times of the range's calls."""
    if r.ranges is None:
        return None
    times = [c.ms() for c in r.ranges.of(_range(spec))]
    times = [t for t in times if t is not None]
    return statistics.median(times) if times else None
