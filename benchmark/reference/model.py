"""Plain PyTorch reference of the port's sparse LM: a GPT-2 style decoder
with causal band attention and a top-1 MoE FFN with capacity slots.

Written from the model's equations, not from the port's code: fp32
throughout with TF32 off (``exact()``), dense attention under the band
mask, the MoE as a loop over experts on the tokens each one keeps. The
semantics the port states are kept: the band (key block within
``window_blocks`` of the query's, key at or before the query), top-1
routing with per-expert capacity slots filled in token order (a token past
an expert's ``capacity`` contributes nothing), the output scaled by the
router probability, the Switch balance loss, layernorm with eps 1e-6,
tanh GELU, a tied LM head. In serving, capacity applies among the prompt's
tokens (prefill) and decoded tokens are never dropped.

The control is the same reference one precision step below the
configuration's (:func:`control_precision`): with ``precision="fp8"`` every
matmul, forward and backward, takes its operands rounded to float8 e4m3
with one scale per tensor (the step below bf16), with ``"bf16"`` rounded to
bfloat16 (the step below an fp32 configuration), accumulating in fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
LAYER_LEAVES = ("wqkv", "wo", "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "moe.router", "moe.w1", "moe.w2")


def exact() -> None:
    """fp32 matmuls in fp32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


CONTROL = {"bfloat16": "fp8", "float16": "fp8", "float32": "bf16"}


def control_precision(cfg: Dict) -> str:
    """The precision one step below the configuration's."""
    return CONTROL[cfg["dtype"]]


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` rounded to ``precision`` (fp8: float8 e4m3 under one
    per-tensor scale), back in fp32."""
    if precision == "bf16":
        return t.to(torch.bfloat16).float()
    s = E4M3_MAX / t.detach().abs().amax().clamp(min=1e-30)
    return (t * s).to(torch.float8_e4m3fn).float() / s


class _LowMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return rounded(a, precision) @ rounded(b, precision)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.precision
        g8 = rounded(g, p)
        ga = g8 @ rounded(b, p).transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = rounded(a, p).transpose(-1, -2) @ g8 if ctx.needs_input_grad[1] else None
        return ga, gb, None


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return a @ b
    if precision in ("bf16", "fp8"):
        return _LowMatmul.apply(a, b, precision)
    raise ValueError(f"precision must be 'fp32', 'bf16' or 'fp8', got {precision!r}")


def layernorm(x, scale, bias, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def band_mask(t: int, window_blocks: int, block_size: int, device) -> torch.Tensor:
    """(t, t) bool: query i may attend key j."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    return (j <= i) & ((i // block_size - j // block_size) < window_blocks)


def attention(x, wqkv, wo, cfg: Dict, precision: str):
    t, d = x.shape
    h = cfg["n_heads"]
    dh = d // h
    qkv = mm(x, wqkv, precision).reshape(t, 3, h, dh).permute(1, 2, 0, 3)
    q, k, v = qkv[0], qkv[1], qkv[2]
    s = mm(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
    s = s.masked_fill(~band_mask(t, cfg["window_blocks"], cfg["block_size"], x.device), float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v, precision)
    return mm(o.permute(1, 0, 2).reshape(t, d), wo, precision)


def moe(x, router, w1, w2, cfg: Dict, precision: str, cap_len: int | None = None, margins=None):
    """Top-1 MoE FFN over x (t, d); capacity applies among the first
    ``cap_len`` tokens (all when None), later tokens are always kept.
    Returns (y, balance loss over the capacity tokens). ``margins``, a
    list, gets each token's gap between its two largest router
    probabilities."""
    t, d = x.shape
    e, f, cap = cfg["n_experts"], cfg["d_ff"], cfg["capacity"]
    n = t if cap_len is None else cap_len
    probs = torch.softmax(mm(x, router, precision), dim=-1)
    prob, expert = probs.max(dim=-1)
    if margins is not None:
        top = probs.detach().topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
    onehot = (expert[:, None] == torch.arange(e, device=x.device)).float()
    rank = ((torch.cumsum(onehot[:n], dim=0) - onehot[:n]) * onehot[:n]).sum(dim=-1)
    keep = torch.ones(t, dtype=torch.bool, device=x.device)
    keep[:n] = rank < cap
    aux = e * torch.sum(probs[:n].mean(dim=0) * onehot[:n].mean(dim=0))
    w1e = w1.reshape(d, e, f)
    w2e = w2.reshape(e, f, d)
    y = torch.zeros_like(x)
    for ex in torch.unique(expert[keep]).tolist():
        idx = torch.nonzero((expert == ex) & keep).squeeze(1)
        hid = F.gelu(mm(x[idx], w1e[:, ex, :], precision), approximate="tanh")
        y = y.index_add(0, idx, mm(hid, w2e[ex], precision) * prob[idx, None])
    return y, aux


def block(x, w: Dict[str, torch.Tensor], cfg: Dict, precision: str, cap_len: int | None = None, margins=None):
    x = x + attention(layernorm(x, w["ln1_scale"], w["ln1_bias"]), w["wqkv"], w["wo"], cfg, precision)
    y, aux = moe(layernorm(x, w["ln2_scale"], w["ln2_bias"]), w["moe.router"], w["moe.w1"], w["moe.w2"],
                 cfg, precision, cap_len, margins)
    return x + y, aux


def layer(params: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {short: params[f"blocks.{i}.{short}"] for short in LAYER_LEAVES}


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: Dict, precision: str = "fp32"):
    """Next-token cross-entropy over the sequence plus the weighted sum of
    the layers' balance losses."""
    x = params["embed"][tokens]
    aux = 0.0
    for i in range(cfg["n_layers"]):
        x, a = block(x, layer(params, i), cfg, precision)
        aux = aux + a
    x = layernorm(x[:-1], params["lnf_scale"], params["lnf_bias"])
    nll = F.cross_entropy(mm(x, params["embed"].T, precision), tokens[1:])
    return nll + cfg["router_aux_weight"] * aux


@torch.no_grad()
def served_logits(load: Callable[[str], torch.Tensor], cfg: Dict, seqs: Sequence[torch.Tensor],
                  prompt_lens: Sequence[int], precision: str = "fp32", margins=None) -> List[torch.Tensor]:
    """For each sequence (prompt then served tokens), the logits that chose
    its served tokens: rows ``tp - 1 .. len - 2``. Runs layer by layer,
    each layer's weights drawn by ``load(name)`` and freed after use.
    ``margins``, a list, gets per sequence the smallest gap over the layers
    between each token's two largest router probabilities."""
    embed = load("embed").float()
    xs = [embed[s] for s in seqs]
    per_layer = [[] for _ in seqs]
    for i in range(cfg["n_layers"]):
        w = {short: load(f"blocks.{i}.{short}").float() for short in LAYER_LEAVES}
        xs = [block(x, w, cfg, precision, cap_len=tp, margins=m)[0] for x, tp, m in zip(xs, prompt_lens, per_layer)]
        del w
    if margins is not None:
        margins.extend(torch.stack(m).amin(dim=0) for m in per_layer)
    scale, bias = load("lnf_scale").float(), load("lnf_bias").float()
    return [mm(layernorm(x[tp - 1: -1], scale, bias), embed.T, precision) for x, tp in zip(xs, prompt_lens)]


def adam_steps(params: Dict[str, torch.Tensor], storage: Dict[str, torch.dtype], batches: Callable[[int], List[torch.Tensor]],
               cfg: Dict, steps: int, lr: float, betas, eps: float, precision: str = "fp32"):
    """``steps`` Adam steps on the mean loss of each step's sequences, with
    fp32 moments; after each update a leaf is rounded to its storage dtype
    (the configuration keeps bf16 weights). Returns (losses per step, the
    first step's gradient norm per leaf); ``params`` hold the result."""
    b1, b2 = betas
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grad_norms = [], {}
    for step in range(1, steps + 1):
        seqs = batches(step)
        total = 0.0
        for tokens in seqs:
            lo = loss(params, tokens, cfg, precision)
            (lo / len(seqs)).backward()
            total += float(lo.detach())
        losses.append(total / len(seqs))
        with torch.no_grad():
            for n, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if step == 1:
                    grad_norms[n] = float(g.norm())
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** step)).sqrt_().add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** step))
                p.copy_(p.to(storage[n]).float())
                p.grad = None
    return losses, grad_norms
