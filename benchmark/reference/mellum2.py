"""Plain PyTorch reference of Mellum2-12B-A2.5B's forward, which decides
``correct`` in the ``mellum2.complete`` cell.

Written from the model's equations (the configuration file's keys), not
from the port's code; fp32 throughout with TF32 off (``exact()``), and no
port kernel or JAX. Per layer, with ``rms(x) = x * rsqrt(mean(x^2) + eps)
* w``:

* ``x += attn(rms(x))``: ``q, k, v = rms(x) Wqkv`` (32 query heads, 4
  key / value heads, head dim 128; query head h reads KV head h // 8);
  RoPE on q and k with transformers' half-split rotation, ``cos(p f_i)``
  and ``sin(p f_i)`` over ``f = concat(inv_freq, inv_freq)``: sliding
  layers ``inv_freq_i = theta^(-2i / 128)``; full layers YaRN,
  ``inv_freq_i / factor * r_i + inv_freq_i * (1 - r_i)`` with ``r_i =
  clamp((i - low) / (high - low), 0, 1)``, ``low = floor(dim(beta_fast))``,
  ``high = ceil(dim(beta_slow))``, ``dim(b) = 128 ln(original / (2 pi
  b)) / (2 ln theta)``, and cos, sin times ``attention_factor``; scores
  ``q k^T / sqrt(128)``, keys ``j <= i`` (full) or ``i - 1024 < j <= i``
  (sliding), softmax, ``p v``, then ``Wo``. Dense attention, in blocks of
  queries so that 16k tokens fit.
* ``x += moe(rms(x))``: ``p = softmax(x W_router)``, its top 8 experts,
  ``p`` renormalised over them, ``y = sum_k p_k w2_e(silu(x w_gate_e) *
  (x w_up_e))``, as a loop over experts.

Then ``rms`` and the untied head. The control (``precision="fp8"``)
rounds every matmul's operands to float8 e4m3 with one scale per tensor,
as ``model.py``'s does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.model import control_precision, exact, mm  # noqa: F401  (the cell's shared helpers)

LAYER_LEAVES = ("wqkv", "wo", "ln1_scale", "ln2_scale", "moe.router", "moe.w13", "moe.w2")
Q_BLOCK = 1024


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def kind_of(cfg: Dict, layer: int) -> str:
    return "full" if cfg["layer_types"][layer] == "full_attention" else "sliding"


def inv_freq(cfg: Dict, kind: str) -> torch.Tensor:
    """(head_dim / 2,) fp64 inverse frequencies of a layer kind."""
    rp = cfg["rope_parameters"]["full_attention" if kind == "full" else "sliding_attention"]
    dim, theta = cfg["head_dim"], float(rp["rope_theta"])
    base = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    if rp.get("rope_type") != "yarn":
        return base
    orig = rp["original_max_position_embeddings"]

    def dim_at(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(dim_at(rp["beta_fast"])), 0)
    high = min(math.ceil(dim_at(rp["beta_slow"])), dim - 1)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low), 0.0, 1.0)
    return base / rp["factor"] * ramp + base * (1.0 - ramp)


def attention_factor(cfg: Dict, kind: str) -> float:
    rp = cfg["rope_parameters"]["full_attention" if kind == "full" else "sliding_attention"]
    return float(rp.get("attention_factor", 1.0)) if rp.get("rope_type") == "yarn" else 1.0


def rope(x: torch.Tensor, cfg: Dict, kind: str) -> torch.Tensor:
    """x (heads, T, dh) at positions 0 .. T - 1, rotated."""
    t, dim = x.shape[-2], x.shape[-1]
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv_freq(cfg, kind).to(x.device)
    ang = torch.cat([ang, ang], dim=-1)
    a = attention_factor(cfg, kind)
    cos, sin = (ang.cos() * a).float(), (ang.sin() * a).float()
    rotated = torch.cat([-x[..., dim // 2:], x[..., :dim // 2]], dim=-1)
    return x * cos + rotated * sin


def attention(x, wqkv, wo, cfg: Dict, kind: str, precision: str) -> torch.Tensor:
    t = x.shape[0]
    h, hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    w = cfg["sliding_window"]
    q, k, v = mm(x, wqkv, precision).split((h * dh, hkv * dh, hkv * dh), dim=-1)
    q = rope(q.reshape(t, h, dh).transpose(0, 1), cfg, kind)
    k = rope(k.reshape(t, hkv, dh).transpose(0, 1), cfg, kind).repeat_interleave(h // hkv, dim=0)
    v = v.reshape(t, hkv, dh).transpose(0, 1).repeat_interleave(h // hkv, dim=0)
    out = torch.empty((h, t, dh), dtype=torch.float32, device=x.device)
    for q0 in range(0, t, Q_BLOCK):
        q1 = min(t, q0 + Q_BLOCK)
        k0 = 0 if kind == "full" else max(0, q0 - w + 1)
        s = mm(q[:, q0:q1], k[:, k0:q1].transpose(-1, -2), precision) / math.sqrt(dh)
        i = torch.arange(q0, q1, device=x.device)[:, None]
        j = torch.arange(k0, q1, device=x.device)[None, :]
        allowed = (j <= i) if kind == "full" else (j <= i) & (j > i - w)
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
        out[:, q0:q1] = mm(p, v[:, k0:q1], precision)
    return mm(out.transpose(0, 1).reshape(t, h * dh), wo, precision)


def moe(x, router, w13, w2, cfg: Dict, precision: str, margins=None) -> torch.Tensor:
    """Top-k SwiGLU MoE over x (t, d). ``margins``, a list, gets each
    token's gap between its k-th and (k+1)-th router probabilities."""
    t, d = x.shape
    e, f, k = cfg["num_experts"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(x, router, precision), dim=-1)
    top = probs.topk(k + 1, dim=-1).values
    if margins is not None:
        margins.append(top[:, k - 1] - top[:, k])
    p, expert = probs.topk(k, dim=-1)
    if cfg["norm_topk_prob"]:
        p = p / p.sum(dim=-1, keepdim=True)
    per_slot = torch.zeros((t, k, d), dtype=torch.float32, device=x.device)
    for ex in torch.unique(expert).tolist():
        tok, slot = torch.nonzero(expert == ex, as_tuple=True)
        gu = mm(x[tok], w13[:, ex * 2 * f:(ex + 1) * 2 * f], precision)
        hid = F.silu(gu[:, :f]) * gu[:, f:]
        per_slot[tok, slot] = mm(hid, w2[ex * f:(ex + 1) * f], precision) * p[tok, slot, None]
    return per_slot.sum(dim=1)


@torch.no_grad()
def served_logits(load: Callable[[str], torch.Tensor], cfg: Dict, seqs: Sequence[torch.Tensor],
                  prompt_lens: Sequence[int], precision: str = "fp32", margins=None) -> List[torch.Tensor]:
    """For each sequence (prompt then served tokens), the logits that chose
    its served tokens: rows ``tp - 1 .. len - 2``. Layer by layer, each
    layer's weights drawn by ``load(name)`` and freed after use; the MoE
    runs on every sequence's tokens at once. ``margins``, a list, gets per
    sequence the smallest top-k router margin over the layers at each
    position."""
    exact()
    eps = cfg["rms_norm_eps"]
    embed = load("embed").float()
    xs = [embed[s] for s in seqs]
    del embed
    lens = [x.shape[0] for x in xs]
    per_layer = []
    for i in range(cfg["num_hidden_layers"]):
        w = {short: load(f"blocks.{i}.{short}").float() for short in LAYER_LEAVES}
        kind = kind_of(cfg, i)
        xs = [x + attention(rms(x, w["ln1_scale"], eps), w["wqkv"], w["wo"], cfg, kind, precision) for x in xs]
        m = [] if margins is not None else None
        ys = moe(rms(torch.cat(xs), w["ln2_scale"], eps), w["moe.router"], w["moe.w13"], w["moe.w2"], cfg,
                 precision, m)
        xs = [x + y for x, y in zip(xs, ys.split(lens))]
        if m is not None:
            per_layer.append(m[0])
        del w, ys
    if margins is not None:
        margins.extend(torch.stack(per_layer).amin(dim=0).split(lens))
    scale, head = load("lnf_scale").float(), load("lm_head").float()
    return [mm(rms(x[tp - 1:-1], scale, eps), head.T, precision) for x, tp in zip(xs, prompt_lens)]
