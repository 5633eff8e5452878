"""Useful operations and bytes of the sparse LM, from shapes.

The yardstick of every ``*_mfu`` and ``*_roofline`` metric. Useful work
counts what the model needs, whatever route the program takes: the dense
projections, one expert per token (top-1, not the padded capacity slots),
attention over the band's (query, key) pairs only, the tied LM head on
the rows whose logits are used. Bytes count each input read once and each
output written once (``sputnik_tpu_torch/bench/models.py`` floors its
byte models at one read per panel pass of a kernel; a layer's floor is
one read in all). Peaks: NVIDIA H100 SXM data sheet, dense, 700 W.
"""

from __future__ import annotations

import functools
from typing import Dict

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2
FP32 = 4


def least_time(flops: float, bytes_moved: float) -> float:
    """The larger of the operations at the bf16 peak and the bytes at HBM
    bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, bytes_moved / HBM_BYTES_PER_S)


@functools.lru_cache(maxsize=None)
def band_pairs(q_lo: int, q_hi: int, window_blocks: int, block_size: int) -> int:
    """(query, key) pairs the band allows for queries ``q_lo .. q_hi - 1``:
    key at or before the query, key block within ``window_blocks`` of the
    query's block."""
    total = 0
    for i in range(q_lo, q_hi):
        lo = max(0, (i // block_size - window_blocks + 1) * block_size)
        total += i - lo + 1
    return total


def attention(cfg: Dict, t: int):
    """Band attention of one sequence of ``t`` tokens, all heads: QK^T and
    PV on the band's pairs; q, k, v read and o written once, in bf16."""
    d = cfg["d_model"]
    flops = 4 * d * band_pairs(0, t, cfg["window_blocks"], cfg["block_size"])
    return flops, 4 * t * d * BF16


def moe(cfg: Dict, tokens: int, experts_read: int | None = None):
    """Top-1 MoE FFN of ``tokens`` tokens: the fp32 router, one expert's two
    projections per token. Bytes: the router, the weights of
    ``experts_read`` experts (all of them when None), the tokens in and out."""
    d, f, e = cfg["d_model"], cfg["d_ff"], cfg["n_experts"]
    flops = 2 * tokens * d * e + 4 * tokens * d * f
    n_exp = e if experts_read is None else experts_read
    return flops, d * e * FP32 + n_exp * 2 * d * f * BF16 + 2 * tokens * d * BF16


def dense(cfg: Dict, tokens: int) -> int:
    """The attention projections (qkv and out) of ``tokens`` tokens."""
    d = cfg["d_model"]
    return 8 * tokens * d * d


def head(cfg: Dict, rows: int) -> int:
    return 2 * rows * cfg["d_model"] * cfg["vocab"]


def forward(cfg: Dict, t: int, logit_rows: int) -> int:
    """One sequence's forward over ``t`` tokens with ``logit_rows`` rows of
    logits."""
    per_layer = dense(cfg, t) + attention(cfg, t)[0] + moe(cfg, t)[0]
    return cfg["n_layers"] * per_layer + head(cfg, logit_rows)


def train_sequence(cfg: Dict, t: int) -> int:
    """Forward and backward (3x the forward) of one training sequence; the
    loss reads ``t - 1`` rows of logits."""
    return 3 * forward(cfg, t, t - 1)


def prefill(cfg: Dict, tp: int) -> int:
    """A prompt's prefill: logits of its last position only."""
    return forward(cfg, tp, 1)


def decode_step(cfg: Dict, batch: int, pos: int) -> int:
    """One decode step of ``batch`` sequences at position ``pos``: each token
    attends the band's keys at or before ``pos``."""
    d = cfg["d_model"]
    keys = band_pairs(pos, pos + 1, cfg["window_blocks"], cfg["block_size"])
    per_layer = dense(cfg, batch) + 4 * d * keys * batch + moe(cfg, batch)[0]
    return cfg["n_layers"] * per_layer + head(cfg, batch)
