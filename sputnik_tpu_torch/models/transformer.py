"""Sparse transformer LM: its loss and its serving loop
(``sputnik_tpu/models/transformer.py``).

Block-sparse causal-band attention (SDD -> masked softmax -> DSD on the
Hopper kernels, or with ``fused_attention`` the flash kernels) plus a top-1
MoE FFN, with layernorms and residuals. Training: :func:`lm_loss` is the
next-token cross-entropy plus the router's balance loss, differentiable in
every parameter (the loop, ``loss.backward()`` and ``torch.optim.Adam``, is
the caller's, as ``examples/sparse_transformer_lm.py`` writes it with
optax). Serving: :func:`lm_prefill` runs the full sparse forward over a
prompt and fills per-layer KV caches; :func:`lm_decode_step` decodes one
token per sequence against the caches, with the band mask (``mode="band"``)
or over content-routed top-k pages (``mode="topk"``);
:func:`lm_generate_batched` prefills each prompt and then decodes the batch
together, greedily or sampling at a temperature from an explicit
``torch.Generator`` (JAX's PRNG key). Serving runs under
``torch.no_grad()`` and builds no graph.

The parameters live in :class:`SparseLM` (an ``nn.Module`` on an explicit
device) whose ``state_dict`` keys follow the JAX parameter tree
(``embed``, ``blocks.<i>.wqkv``, ``blocks.<i>.moe.w1``, ``lnf_scale`` ...).
The functions take the module where the JAX ones take the tree. JAX's
``vmap`` over the batch becomes an explicit batch axis and its ``scan``
over tokens a Python loop; the decode caches are updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.models import attention as attn_lib
from sputnik_tpu_torch.models import moe as moe_lib
from sputnik_tpu_torch.utils import tracing
from sputnik_tpu_torch.utils.device import resolve_device

__all__ = [
    "TransformerConfig",
    "Block",
    "SparseLM",
    "init_lm_params",
    "block_forward",
    "lm_topologies",
    "lm_forward",
    "lm_loss",
    "init_decode_caches",
    "block_decode",
    "lm_prefill",
    "lm_decode_step",
    "lm_generate",
    "lm_generate_batched",
    "decode_tokens",
    "sample_tokens",
]

Caches = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    d_model: int = 256
    n_heads: int = 4
    seq_len: int = 512
    window_blocks: int = 2  # attention band half-width, in 128-blocks
    n_experts: int = 4
    d_ff: int = 512
    capacity: Optional[int] = None  # None -> seq_len // n_experts
    n_layers: int = 2
    vocab: int = 1024
    dtype: torch.dtype = torch.bfloat16
    # Attention through the flash kernels (flash_mha) instead of SDD ->
    # softmax -> DSD; prefill honours it too.
    fused_attention: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    def moe_cfg(self) -> moe_lib.MoEConfig:
        cap = self.capacity or max(self.seq_len // self.n_experts, 128)
        return moe_lib.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            capacity=cap, dtype=self.dtype,
        )


def _param(*shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class Block(nn.Module):
    """One transformer block's parameters (JAX: ``params["blocks"][i]``), on
    ``device`` (``None``: the card)."""

    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        self.wqkv = _param(d, 3 * d, dtype=cfg.dtype, device=device)
        self.wo = _param(d, d, dtype=cfg.dtype, device=device)
        for name in ("ln1", "ln2"):
            setattr(self, f"{name}_scale", nn.Parameter(torch.ones(d, device=device)))
            setattr(self, f"{name}_bias", _param(d, dtype=torch.float32, device=device))
        self.moe = moe_lib.MoE(cfg.moe_cfg(), device=device)


class SparseLM(nn.Module):
    """The sparse LM's parameters on ``device`` (``None``: the card);
    ``forward(tokens)`` is :func:`lm_forward`."""

    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = _param(cfg.vocab, d, dtype=cfg.dtype, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device=device) for _ in range(cfg.n_layers))
        self.lnf_scale = nn.Parameter(torch.ones(d, device=device))
        self.lnf_bias = _param(d, dtype=torch.float32, device=device)

    def forward(self, tokens: torch.Tensor):
        return lm_forward(self, tokens, self.cfg)


def init_lm_params(cfg: TransformerConfig, generator: torch.Generator, device=None) -> SparseLM:
    """A :class:`SparseLM` with random weights drawn from ``generator`` at the
    JAX package's scales (normal / sqrt(fan-in)); layernorms start at 1, 0.
    ``device=None`` builds on the card."""
    device = resolve_device(device)
    lm = SparseLM(cfg, device=device)
    s = 1.0 / math.sqrt(cfg.d_model)
    moe_lib.normal_(lm.embed, s, generator)
    for b in lm.blocks:
        moe_lib.normal_(b.wqkv, s, generator)
        moe_lib.normal_(b.wo, s, generator)
        b.moe = moe_lib.init_moe_params(cfg.moe_cfg(), generator, device)
    return lm


def _layernorm(x, scale, bias, eps=1e-6):
    """fp32 layernorm with population variance and eps 1e-6 (not
    ``nn.LayerNorm``'s 1e-5), returned in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """fp32 LM-head logits of storage-dtype operands (JAX:
    ``preferred_element_type=float32``), so argmax sees unrounded sums."""
    return x.float() @ embed.float().T


def _attention_block(params: Block, x, cfg: TransformerConfig, topology):
    """x + attention(ln1(x)); also returns the (H, T, dh) k and v."""
    t, d = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    a_in = _layernorm(x, params.ln1_scale, params.ln1_bias)
    qkv = (a_in @ params.wqkv).to(cfg.dtype).reshape(t, 3, h, dh).permute(1, 2, 0, 3)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (H, T, dh)
    o = attn_lib.multihead_block_sparse_attention(q, k, v, topology, causal=True, fused=cfg.fused_attention)
    o = o.permute(1, 0, 2).reshape(t, d)
    return x + (o @ params.wo).to(cfg.dtype), k, v


def block_forward(
    params: Block,
    x: torch.Tensor,  # (T, d_model)
    cfg: TransformerConfig,
    topology: BlockSparseMatrix,
    moe_topology: Optional[BlockSparseMatrix] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block: causal block-sparse attention + MoE FFN. Returns (y, aux)."""
    x, _, _ = _attention_block(params, x, cfg, topology)
    f_in = _layernorm(x, params.ln2_scale, params.ln2_bias)
    f_out, aux = moe_lib.moe_forward(params.moe, f_in, cfg.moe_cfg(), moe_topology)
    return x + f_out.to(cfg.dtype), aux


def lm_topologies(cfg: TransformerConfig, device=None):
    """(attention topology, moe topology) on ``device``: build once, reuse.
    The attention topology carries its transpose metadata, which the
    backward's column walks read; the MoE topology is the block-diagonal
    one of ``cfg.moe_cfg()`` (the LM's grouped MoE does not read it; the
    bsr impls of ``moe_forward`` do). ``device=None`` builds on the card."""
    topo = attn_lib.causal_block_topology(
        cfg.seq_len, block_size=128, window_blocks=cfg.window_blocks, dtype=cfg.dtype, device=device
    )
    return topo.with_transpose_metadata(), moe_lib.block_diag_topology(cfg.moe_cfg(), device=device)


def lm_forward(params: SparseLM, tokens: torch.Tensor, cfg: TransformerConfig, topos=None):
    """tokens (T,) -> (logits (T, vocab) fp32, aux_sum)."""
    if topos is None:
        topos = lm_topologies(cfg, device=params.embed.device)
    topo, moe_topo = topos
    x = params.embed[tokens.long()]
    aux_total = 0.0
    for bp in params.blocks:
        x, aux = block_forward(bp, x, cfg, topo, moe_topo)
        aux_total = aux_total + aux
    x = _layernorm(x, params.lnf_scale, params.lnf_bias)
    return _logits(x, params.embed), aux_total


@tracing.traced("loss", inputs=(1,))
def lm_loss(params: SparseLM, tokens: torch.Tensor, cfg: TransformerConfig, topos=None) -> torch.Tensor:
    """Next-token cross-entropy (fp32 log-softmax of the logits at every
    position but the last) plus 0.01 times the summed router aux loss."""
    logits, aux = lm_forward(params, tokens, cfg, topos)
    lp = torch.log_softmax(logits[:-1].float(), dim=-1)
    nll = -lp.gather(-1, tokens[1:].long()[:, None]).mean()
    return nll + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving: per-layer KV caches and band decoding.
# ---------------------------------------------------------------------------


def init_decode_caches(cfg: TransformerConfig, max_len: int, *, device=None) -> Caches:
    """Per-layer {"k", "v"} caches of shape (H, max_len, dh), zero-filled;
    ``max_len`` must be a multiple of 128 (the page size). ``device=None``
    builds on the card."""
    if max_len % 128:
        raise ValueError(f"max_len {max_len} must be a multiple of 128")
    device = resolve_device(device)
    shape = (cfg.n_heads, max_len, cfg.d_head)
    return [
        {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
         "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
        for _ in range(cfg.n_layers)
    ]


def block_decode(params: Block, x: torch.Tensor, cfg: TransformerConfig, cache, pos: int, *, mode: str = "band",
                 k_pages: Optional[int] = None):
    """One block for one token per sequence at position ``pos``: x is
    (..., d), the caches (..., H, max_len, dh) and written in place.
    ``mode="band"`` reproduces the training band topology's mask exactly;
    ``mode="topk"`` attends over ``k_pages`` (default ``window_blocks``)
    cache pages chosen by content among positions ``<= pos``. Returns y
    (..., d)."""
    if mode not in ("band", "topk"):
        raise ValueError(f"mode must be 'band' or 'topk', got {mode!r}")
    lead = x.shape[:-1]
    a_in = _layernorm(x, params.ln1_scale, params.ln1_bias)
    qkv = (a_in @ params.wqkv).to(cfg.dtype).reshape(lead + (3, cfg.n_heads, cfg.d_head))
    q, k_new, v_new = qkv.unbind(dim=-3)  # (..., H, dh)
    cache["k"][..., pos, :] = k_new
    cache["v"][..., pos, :] = v_new
    if mode == "band":
        o = attn_lib.decode_band_attention(q, cache["k"], cache["v"], cfg.window_blocks, pos)
    else:
        o = attn_lib.decode_topk_attention(q, cache["k"], cache["v"],
                                           cfg.window_blocks if k_pages is None else k_pages, valid_len=pos + 1)
    x = x + (o.reshape(lead + (cfg.d_model,)) @ params.wo).to(cfg.dtype)
    f_in = _layernorm(x, params.ln2_scale, params.ln2_bias)
    return x + moe_lib.moe_one(params.moe, f_in, cfg.moe_cfg())


@torch.no_grad()
def lm_prefill(params: SparseLM, prompt: torch.Tensor, cfg: TransformerConfig, max_len: int):
    """Full sparse forward over ``prompt`` (Tp,), capturing per-layer K/V into
    decode caches. Returns (caches, last-position logits (vocab,))."""
    tp = int(prompt.shape[0])
    if tp < 128 or tp % 128 or tp > max_len:
        raise ValueError(f"prompt length {tp} must be a nonzero 128-multiple <= {max_len}")
    # Keep the resolved capacity: deriving it from the shorter seq_len would
    # let prefill drop tokens the full forward keeps.
    pre_cfg = dataclasses.replace(cfg, seq_len=tp, capacity=cfg.moe_cfg().capacity)
    device = params.embed.device
    # The grouped MoE needs no topology; only the attention one is built.
    topo = attn_lib.causal_block_topology(
        tp, block_size=128, window_blocks=cfg.window_blocks, dtype=cfg.dtype, device=device
    )
    caches = init_decode_caches(cfg, max_len, device=device)
    x = params.embed[prompt.long()]
    for cache, bp in zip(caches, params.blocks):
        x, k, v = _attention_block(bp, x, pre_cfg, topo)
        cache["k"][:, :tp] = k
        cache["v"][:, :tp] = v
        f_in = _layernorm(x, bp.ln2_scale, bp.ln2_bias)
        f_out, _ = moe_lib.moe_forward(bp.moe, f_in, pre_cfg.moe_cfg())
        x = x + f_out.to(cfg.dtype)
    x = _layernorm(x, params.lnf_scale, params.lnf_bias)
    return caches, _logits(x[-1], params.embed)


@tracing.traced("decode_step", inputs=(1,))
@torch.no_grad()
def lm_decode_step(params: SparseLM, token: torch.Tensor, caches: Caches, pos: int,
                   cfg: TransformerConfig, *, mode: str = "band", k_pages: Optional[int] = None):
    """One decode step: token ids (...,) -> logits (..., vocab); the caches
    are updated in place and returned."""
    x = params.embed[token.long()]
    for bp, cache in zip(params.blocks, caches):
        x = block_decode(bp, x, cfg, cache, pos, mode=mode, k_pages=k_pages)
    x = _layernorm(x, params.lnf_scale, params.lnf_bias)
    return _logits(x, params.embed), caches


def sample_tokens(logits: torch.Tensor, temperature: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Token ids from logits (..., vocab): the argmax at ``temperature <=
    0``, else a draw from ``softmax(logits / temperature)`` by the
    Gumbel-max rule on uniforms from ``generator`` (on the logits' device),
    as ``jax.random.categorical`` draws. The draws are not JAX's bits."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return (logits.float() / temperature + gumbel).argmax(dim=-1)


@torch.no_grad()
def decode_tokens(params: SparseLM, first_logits: torch.Tensor, caches: Caches, tp: int, cfg: TransformerConfig,
                  n_new: int, *, mode: str = "band", k_pages: Optional[int] = None, temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The decode loop after prefill: pick a token from ``first_logits``
    (B, vocab), then ``n_new - 1`` steps at positions ``tp``, ``tp + 1``, ...
    (the caches are updated in place). Returns (B, n_new) token ids."""
    token = sample_tokens(first_logits, temperature, generator)
    tracing.mark("first_token", token.device, rows=token.numel())
    out = [token]
    for i in range(n_new - 1):
        logits, caches = lm_decode_step(params, token, caches, tp + i, cfg, mode=mode, k_pages=k_pages)
        token = sample_tokens(logits, temperature, generator)
        out.append(token)
    return torch.stack(out, dim=1)


@torch.no_grad()
def lm_generate_batched(
    params: SparseLM,
    prompts: torch.Tensor,  # (B, Tp)
    cfg: TransformerConfig,
    n_new: int,
    *,
    max_len: Optional[int] = None,
    mode: str = "band",
    k_pages: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Batched generation: one sparse prefill per prompt, then the batch
    decodes together, one Python step per token, all sequences at the same
    position. ``temperature=0`` is greedy; ``temperature > 0`` samples from
    ``softmax(logits / temperature)`` with ``generator`` (on the model's
    device), and raises without one, as the JAX package raises without a
    key. Returns (B, n_new) token ids."""
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    if prompts.ndim != 2:
        raise ValueError(f"prompts must be (B, Tp), got {tuple(prompts.shape)}")
    bsz, tp = prompts.shape
    max_len = max_len or cfg.seq_len
    if tp + n_new > max_len:
        raise ValueError(f"prompt ({tp}) + n_new ({n_new}) exceeds max_len {max_len}")
    with tracing.span("generate", prompts.device, new_call=True):
        per_seq = []
        for i in range(bsz):
            with tracing.span("prefill", prompts.device, row=i):
                per_seq.append(lm_prefill(params, prompts[i], cfg, max_len))
        caches = [
            {name: torch.stack([c[layer][name] for c, _ in per_seq]) for name in ("k", "v")}
            for layer in range(cfg.n_layers)
        ]
        first = torch.stack([logits for _, logits in per_seq])
        return decode_tokens(params, first, caches, tp, cfg, n_new, mode=mode, k_pages=k_pages,
                             temperature=temperature, generator=generator)


def lm_generate(params: SparseLM, prompt: torch.Tensor, cfg: TransformerConfig, n_new: int, *,
                max_len: Optional[int] = None, mode: str = "band", k_pages: Optional[int] = None,
                temperature: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Generation for one prompt (Tp,); returns (n_new,) token ids."""
    return lm_generate_batched(params, prompt[None], cfg, n_new, max_len=max_len, mode=mode, k_pages=k_pages,
                               temperature=temperature, generator=generator)[0]
