"""Useful operations and bytes of Mellum2 (GQA, full and sliding layers,
top-k SwiGLU MoE, untied head), from shapes: the yardstick of the
``mellum2.complete`` cell's ``serve_mfu``, ``attn_roofline`` and
``moe_roofline``. As ``flops.py`` counts the sparse LM's: 2 operations a
multiply-add; attention over the (query, key) pairs its mask allows; the
MoE's fp32 router and each token's k experts (not the padded rows); the
head on the rows whose logits are used. Bytes: each input read once and
each output written once, the experts' weights of those that hold tokens.
"""

from __future__ import annotations

from typing import Dict

from benchmark.flops import BF16, FP32, PEAK_BF16_FLOPS, least_time  # noqa: F401  (the metrics read the last two)


def kinds(cfg: Dict):
    return ["full" if k == "full_attention" else "sliding" for k in cfg["layer_types"]]


def pairs(t: int, kind: str, window: int) -> int:
    """(query, key) pairs of ``t`` causal queries at positions 0 .. t - 1:
    every earlier key and itself (full), at most ``window`` of them
    (sliding)."""
    if kind == "full" or t <= window:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def keys_at(pos: int, kind: str, window: int) -> int:
    """Keys the query at ``pos`` attends."""
    return pos + 1 if kind == "full" else min(pos + 1, window)


def _widths(cfg):
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"],
            cfg["num_experts"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"])


def projections(cfg: Dict, tokens: int) -> int:
    """Wqkv (H + 2 H_kv heads) and Wo of ``tokens`` tokens."""
    d, h, hkv, dh, *_ = _widths(cfg)
    return 2 * tokens * d * (h + 2 * hkv) * dh + 2 * tokens * h * dh * d


def attention(cfg: Dict, t: int, kind: str):
    """A prefill's attention over ``t`` tokens in a layer of ``kind``: QK^T
    and PV on the allowed pairs, all query heads; q, o (H heads) and k, v
    (H_kv heads) read or written once in bf16."""
    _, h, hkv, dh, *_ = _widths(cfg)
    flops = 4 * h * dh * pairs(t, kind, cfg["sliding_window"])
    return flops, (2 * h + 2 * hkv) * t * dh * BF16


def moe(cfg: Dict, tokens: int, experts_read: int):
    """The top-k SwiGLU MoE of ``tokens`` tokens: the fp32 router, then per
    token k experts' gate, up and down products. Bytes: the router, the
    weights of ``experts_read`` experts, the tokens in and out."""
    d, _, _, _, e, f, k = _widths(cfg)
    flops = 2 * tokens * d * e + 6 * tokens * k * d * f
    return flops, d * e * FP32 + experts_read * 3 * d * f * BF16 + 2 * tokens * d * BF16


def head(cfg: Dict, rows: int) -> int:
    return 2 * rows * cfg["hidden_size"] * cfg["vocab_size"]


def prefill(cfg: Dict, tp: int) -> int:
    """A prompt's prefill, the logits of its last position only."""
    per = sum(projections(cfg, tp) + attention(cfg, tp, kind)[0] for kind in kinds(cfg))
    return per + cfg["num_hidden_layers"] * moe(cfg, tp, 0)[0] + head(cfg, 1)


def decode_step(cfg: Dict, batch: int, pos: int) -> int:
    """One decode step of ``batch`` sequences at position ``pos``."""
    _, h, _, dh, *_ = _widths(cfg)
    w = cfg["sliding_window"]
    per = sum(projections(cfg, batch) + 4 * h * dh * keys_at(pos, kind, w) * batch for kind in kinds(cfg))
    return per + cfg["num_hidden_layers"] * moe(cfg, batch, 0)[0] + head(cfg, batch)
