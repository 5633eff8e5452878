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

The same family serves models with grouped-query attention, an explicit
head size, RMSNorm, rotary positions (with YaRN in full layers), layers of
two kinds (``full``: causal over every earlier key; ``sliding``: a
token-exact window) and a dropless top-k SwiGLU MoE with an untied head,
as Mellum2 (``benchmark/configs/mellum2-12b-a2.5b.json``). Per layer, with
``rms(x) = x * rsqrt(mean(x^2) + 1e-6) * w`` in fp32:
``x += attn(rms(x)); x += moe(rms(x))``, then ``rms`` and the head's fp32
logits. Attention: ``q, k, v = rms(x) Wqkv`` split into H query heads and
H_kv key / value heads of ``head_dim``, RoPE on q and k (transformers'
half-split rotation, ``inv_freq_i = theta^(-2i / head_dim)``; full layers
with YaRN: ``inv_freq_i / factor * r_i + inv_freq_i * (1 - r_i)``, ``r_i``
the clamped ramp between transformers' ``low`` and ``high`` correction
dims, cos and sin times the attention factor), ``softmax(q k^T /
sqrt(head_dim))`` under the layer's mask, each query head on key / value
head ``h // (H / H_kv)``, and ``o Wo``. Every default of
:class:`TransformerConfig` keeps the MegaBlocks model above as it was.

The parameters live in :class:`SparseLM` (an ``nn.Module`` on an explicit
device) whose ``state_dict`` keys follow the JAX parameter tree
(``embed``, ``blocks.<i>.wqkv``, ``blocks.<i>.moe.w1``, ``lnf_scale`` ...).
The functions take the module where the JAX ones take the tree. JAX's
``vmap`` over the batch becomes an explicit batch axis and its ``scan``
over tokens a Python loop; the decode caches are updated in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
    "RopeConfig",
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
    "DecodeGraph",
    "graphable",
    "lm_generate",
    "lm_generate_batched",
    "decode_tokens",
    "sample_tokens",
]

Caches = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    """Rotary positions: base ``theta``; with ``yarn_factor`` the full
    layers take YaRN (transformers' ``_compute_yarn_parameters``) over
    ``original_max_position``, with ``beta_fast`` / ``beta_slow`` and cos,
    sin scaled by ``attention_factor``; sliding layers stay plain."""

    theta: float
    yarn_factor: Optional[float] = None
    original_max_position: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float = 1.0


LAYER_KINDS = ("full", "sliding")


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
    n_kv_heads: Optional[int] = None  # GQA: key / value heads, a divisor of n_heads (None: n_heads)
    head_dim: Optional[int] = None  # None: d_model // n_heads
    norm: str = "layernorm"  # or "rmsnorm" (scale only, eps 1e-6)
    rope: Optional[RopeConfig] = None  # None: no position encoding
    # Per layer "full" or "sliding" (None: every layer takes the band of
    # window_blocks); a sliding layer's window in tokens, a multiple of 128.
    layer_kinds: Optional[Tuple[str, ...]] = None
    window: int = 0
    top_k: int = 1
    norm_topk_prob: bool = False
    # "capacity": moe_forward's top-1 GELU experts in capacity slots;
    # "dropless": topk_moe_forward's top-k SwiGLU experts.
    moe_route: str = "capacity"
    tied_head: bool = True  # False: an lm_head leaf (vocab, d_model)

    def __post_init__(self):
        if self.n_heads % self.kv_heads:
            raise ValueError(f"n_heads {self.n_heads} must be a multiple of n_kv_heads {self.kv_heads}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm must be 'layernorm' or 'rmsnorm', got {self.norm!r}")
        if self.layer_kinds is not None:
            if len(self.layer_kinds) != self.n_layers or not set(self.layer_kinds) <= set(LAYER_KINDS):
                raise ValueError(f"layer_kinds must give 'full' or 'sliding' for each of {self.n_layers} layers")
            if "sliding" in self.layer_kinds and (self.window <= 0 or self.window % 128):
                raise ValueError(f"a sliding layer's window must be a positive multiple of 128, got {self.window}")
        if self.moe_route not in ("capacity", "dropless"):
            raise ValueError(f"moe_route must be 'capacity' or 'dropless', got {self.moe_route!r}")
        if self.moe_route == "capacity" and self.top_k != 1:
            raise ValueError("the capacity route is top-1; top-k takes 'dropless'")

    @property
    def d_head(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def kind(self, layer: int) -> str:
        """Layer ``layer``'s kind: "full", "sliding", or "band" without
        ``layer_kinds``."""
        return "band" if self.layer_kinds is None else self.layer_kinds[layer]

    def moe_cfg(self) -> moe_lib.MoEConfig:
        cap = self.capacity or max(self.seq_len // self.n_experts, 128)
        return moe_lib.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            capacity=cap, dtype=self.dtype, top_k=self.top_k, norm_topk_prob=self.norm_topk_prob,
            activation="swiglu" if self.moe_route == "dropless" else "gelu",
        )


def _param(*shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class Block(nn.Module):
    """One transformer block's parameters (JAX: ``params["blocks"][i]``), on
    ``device`` (``None``: the card)."""

    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.d_head
        self.wqkv = _param(d, (h + 2 * hkv) * dh, dtype=cfg.dtype, device=device)
        self.wo = _param(h * dh, d, dtype=cfg.dtype, device=device)
        for name in ("ln1", "ln2"):
            setattr(self, f"{name}_scale", nn.Parameter(torch.ones(d, device=device)))
            if cfg.norm == "layernorm":
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
        if cfg.norm == "layernorm":
            self.lnf_bias = _param(d, dtype=torch.float32, device=device)
        if not cfg.tied_head:
            self.lm_head = _param(cfg.vocab, d, dtype=cfg.dtype, device=device)

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
        moe_lib.normal_(b.wo, 1.0 / math.sqrt(b.wo.shape[0]), generator)
        b.moe = moe_lib.init_moe_params(cfg.moe_cfg(), generator, device)
    if not cfg.tied_head:
        moe_lib.normal_(lm.lm_head, s, generator)
    return lm


def _layernorm(x, scale, bias, eps=1e-6):
    """fp32 layernorm with population variance and eps 1e-6 (not
    ``nn.LayerNorm``'s 1e-5), returned in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _rmsnorm(x, scale, eps=1e-6):
    """fp32 ``x * rsqrt(mean(x^2) + eps) * scale``, returned in x's dtype."""
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps) * scale).to(x.dtype)


def _norm(params, name: str, x, cfg: TransformerConfig):
    """The norm ``name`` ("ln1", "ln2", "lnf") of ``params`` on x."""
    if cfg.norm == "rmsnorm":
        return _rmsnorm(x, getattr(params, f"{name}_scale"))
    return _layernorm(x, getattr(params, f"{name}_scale"), getattr(params, f"{name}_bias"))


def _logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """fp32 LM-head logits of storage-dtype operands (JAX:
    ``preferred_element_type=float32``), so argmax sees unrounded sums."""
    return x.float() @ embed.float().T


def _head(params: SparseLM, cfg: TransformerConfig) -> torch.Tensor:
    return params.embed if cfg.tied_head else params.lm_head


@functools.lru_cache(maxsize=None)
def rope_inv_freq(rope: RopeConfig, head_dim: int, yarn: bool) -> torch.Tensor:
    """(head_dim / 2,) fp64 inverse frequencies on the CPU: ``theta^(-2i /
    head_dim)``, or with ``yarn`` (and a ``yarn_factor``) transformers'
    YaRN blend ``inv / factor * r + inv * (1 - r)``, ``r_i = clamp((i -
    low) / (high - low), 0, 1)``, low and high the floor and ceil of the
    dims at which ``beta_fast`` and ``beta_slow`` rotations fit the
    original context, clipped to [0, head_dim - 1]."""
    inv = rope.theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim)
    if not yarn or rope.yarn_factor is None:
        return inv

    def dim_of(rotations: float) -> float:
        return head_dim * math.log(rope.original_max_position / (rotations * 2 * math.pi)) / (2 * math.log(rope.theta))

    low = max(math.floor(dim_of(rope.beta_fast)), 0)
    high = min(math.ceil(dim_of(rope.beta_slow)), head_dim - 1)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float64) - low) / max(high - low, 1e-3)).clamp(0, 1)
    return inv / rope.yarn_factor * ramp + inv * (1 - ramp)


@functools.lru_cache(maxsize=None)
def _inv_freq_on(rope: RopeConfig, head_dim: int, yarn: bool, device: str) -> torch.Tensor:
    """:func:`rope_inv_freq` kept on ``device``, so that a step captured in
    a CUDA graph copies nothing from the host."""
    return rope_inv_freq(rope, head_dim, yarn).to(device)


def rope_tables(cfg: TransformerConfig, kind: str, start, stop: Optional[int], device):
    """(cos, sin), each (stop - start, head_dim) fp32, for positions
    ``start .. stop - 1`` of a layer of ``kind``: angles in fp64, the YaRN
    frequencies and attention factor in full layers when the rope has a
    ``yarn_factor``. ``start`` may be a 0-d integer tensor on ``device``
    with ``stop`` None: the one position it holds, read on the device."""
    yarn = kind == "full" and cfg.rope.yarn_factor is not None
    inv = _inv_freq_on(cfg.rope, cfg.d_head, yarn, str(torch.device(device)))
    if isinstance(start, torch.Tensor):
        positions = start.reshape(1).to(torch.float64)
    else:
        positions = torch.arange(start, stop, dtype=torch.float64, device=device)
    ang = positions[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    factor = cfg.rope.attention_factor if yarn else 1.0
    return (emb.cos() * factor).float(), (emb.sin() * factor).float()


def _rope_by_kind(cfg: TransformerConfig, start, stop: Optional[int], device) -> Dict[str, tuple]:
    """{kind: (cos, sin)} of every layer kind of the model (empty without
    a rope); ``start`` and ``stop`` as :func:`rope_tables` takes them."""
    if cfg.rope is None:
        return {}
    return {kind: rope_tables(cfg, kind, start, stop, device) for kind in {cfg.kind(i) for i in range(cfg.n_layers)}}


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """transformers' ``x * cos + rotate_half(x) * sin`` in fp32, returned
    in x's dtype; cos and sin broadcast over x's leading axes."""
    x32 = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos + rotated * sin).to(x.dtype)


def _kind_span(kind: str, device):
    """The span ``attention.<kind>`` of a full or sliding layer's attention
    (none for the band)."""
    return contextlib.nullcontext() if kind == "band" else tracing.span(f"attention.{kind}", device)


def _layer_window(cfg: TransformerConfig, kind: str) -> int:
    """Tokens of the layer's token-exact window (0: none)."""
    return cfg.window if kind == "sliding" else 0


def _topology(cfg: TransformerConfig, kind: str, t: int, device) -> BlockSparseMatrix:
    """The attention topology of a layer of ``kind`` over ``t`` tokens: the
    band of ``window_blocks``, full causal, or the band of the window's
    blocks plus the one it cuts (``window / 128 + 1``)."""
    window_blocks = {"band": cfg.window_blocks, "full": None, "sliding": cfg.window // 128 + 1}[kind]
    return attn_lib.causal_block_topology(t, block_size=128, window_blocks=window_blocks, dtype=cfg.dtype,
                                          device=device)


def _moe(params, x, cfg: TransformerConfig, moe_cfg: moe_lib.MoEConfig, moe_topology=None):
    """(y, aux) of the layer's MoE by its route; the dropless top-k route
    has no balance loss."""
    if cfg.moe_route == "dropless":
        return moe_lib.topk_moe_forward(params, x, moe_cfg), 0.0
    return moe_lib.moe_forward(params, x, moe_cfg, moe_topology)


def _attention_block(params: Block, x, cfg: TransformerConfig, topology, kind: str = "band", rope=None):
    """x + attention(norm1(x)); also returns the (H_kv, T, dh) k (rotated)
    and v."""
    t = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.d_head
    a_in = _norm(params, "ln1", x, cfg)
    q, k, v = (a_in @ params.wqkv).to(cfg.dtype).split((h * dh, hkv * dh, hkv * dh), dim=-1)
    q = q.reshape(t, h, dh).transpose(0, 1)  # (H, T, dh)
    k = k.reshape(t, hkv, dh).transpose(0, 1)
    v = v.reshape(t, hkv, dh).transpose(0, 1)
    if rope is not None:
        q, k = _rotate(q, *rope), _rotate(k, *rope)
    with _kind_span(kind, x.device):
        o = attn_lib.multihead_block_sparse_attention(q, k, v, topology, causal=True, fused=cfg.fused_attention,
                                                      window=_layer_window(cfg, kind))
    o = o.transpose(0, 1).reshape(t, h * dh)
    return x + (o @ params.wo).to(cfg.dtype), k, v


def block_forward(
    params: Block,
    x: torch.Tensor,  # (T, d_model)
    cfg: TransformerConfig,
    topology,
    moe_topology: Optional[BlockSparseMatrix] = None,
    *,
    kind: str = "band",
    rope=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block: causal block-sparse attention + MoE FFN. Returns (y, aux).
    ``topology`` is the layer's, or {kind: topology} (:func:`lm_topologies`
    of a model with layer kinds); ``rope`` the layer kind's (cos, sin)."""
    if isinstance(topology, dict):
        topology = topology[kind]
    x, _, _ = _attention_block(params, x, cfg, topology, kind, rope)
    f_in = _norm(params, "ln2", x, cfg)
    f_out, aux = _moe(params.moe, f_in, cfg, cfg.moe_cfg(), moe_topology)
    return x + f_out.to(cfg.dtype), aux


def lm_topologies(cfg: TransformerConfig, device=None):
    """(attention topology, moe topology) on ``device``: build once, reuse.
    The attention topology carries its transpose metadata, which the
    backward's column walks read; the MoE topology is the block-diagonal
    one of ``cfg.moe_cfg()`` (the LM's grouped MoE does not read it; the
    bsr impls of ``moe_forward`` do). With ``layer_kinds`` the attention
    topology is {kind: topology} and the dropless route has no MoE
    topology. ``device=None`` builds on the card."""
    if cfg.layer_kinds is not None:
        topo = {kind: _topology(cfg, kind, cfg.seq_len, device).with_transpose_metadata()
                for kind in set(cfg.layer_kinds)}
    else:
        topo = _topology(cfg, "band", cfg.seq_len, device).with_transpose_metadata()
    moe_topo = None if cfg.moe_route == "dropless" else moe_lib.block_diag_topology(cfg.moe_cfg(), device=device)
    return topo, moe_topo


def lm_forward(params: SparseLM, tokens: torch.Tensor, cfg: TransformerConfig, topos=None):
    """tokens (T,) -> (logits (T, vocab) fp32, aux_sum)."""
    if topos is None:
        topos = lm_topologies(cfg, device=params.embed.device)
    topo, moe_topo = topos
    x = params.embed[tokens.long()]
    ropes = _rope_by_kind(cfg, 0, x.shape[0], x.device)
    aux_total = 0.0
    for i, bp in enumerate(params.blocks):
        kind = cfg.kind(i)
        x, aux = block_forward(bp, x, cfg, topo, moe_topo, kind=kind, rope=ropes.get(kind))
        aux_total = aux_total + aux
    x = _norm(params, "lnf", x, cfg)
    return _logits(x, _head(params, cfg)), aux_total


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
    """Per-layer {"k", "v"} caches of shape (H_kv, max_len, dh), zero-filled;
    ``max_len`` must be a multiple of 128 (the page size). ``device=None``
    builds on the card."""
    if max_len % 128:
        raise ValueError(f"max_len {max_len} must be a multiple of 128")
    device = resolve_device(device)
    shape = (cfg.kv_heads, max_len, cfg.d_head)
    return [
        {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
         "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
        for _ in range(cfg.n_layers)
    ]


def block_decode(params: Block, x: torch.Tensor, cfg: TransformerConfig, cache, pos: int, *, mode: str = "band",
                 k_pages: Optional[int] = None, kind: str = "band", rope=None):
    """One block for one token per sequence at position ``pos``: x is
    (..., d), the caches (..., H_kv, max_len, dh) and written in place.
    A full or sliding layer (``kind``) attends every key ``<= pos`` or the
    keys of its token-exact window (``decode_window_attention``, GQA on the
    cache in place), with ``rope`` the kind's (cos, sin) at ``pos``. A band
    layer: ``mode="band"`` reproduces the training band topology's mask
    exactly; ``mode="topk"`` attends over ``k_pages`` (default
    ``window_blocks``) cache pages chosen by content among positions ``<=
    pos``. The MoE is ``moe_one`` on the capacity route, else
    ``topk_moe_forward`` over the batch's tokens. A full or sliding layer
    also takes ``pos`` as a 0-d integer tensor on the device (the step of a
    :class:`DecodeGraph`). Returns y (..., d)."""
    if mode not in ("band", "topk") or (kind != "band" and mode != "band"):
        raise ValueError(f"mode must be 'band' or 'topk' (full and sliding layers: 'band'), got {mode!r}")
    if kind == "band" and isinstance(pos, torch.Tensor):
        raise ValueError("a band layer takes its position as a host int")
    lead = x.shape[:-1]
    h, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.d_head
    a_in = _norm(params, "ln1", x, cfg)
    q, k_new, v_new = (a_in @ params.wqkv).to(cfg.dtype).split((h * dh, hkv * dh, hkv * dh), dim=-1)
    q, k_new, v_new = q.reshape(lead + (h, dh)), k_new.reshape(lead + (hkv, dh)), v_new.reshape(lead + (hkv, dh))
    if rope is not None:
        q, k_new = _rotate(q, *rope), _rotate(k_new, *rope)
    if isinstance(pos, torch.Tensor):
        at = cache["k"].ndim - 2
        cache["k"].index_copy_(at, pos.reshape(1), k_new.unsqueeze(-2))
        cache["v"].index_copy_(at, pos.reshape(1), v_new.unsqueeze(-2))
    else:
        cache["k"][..., pos, :] = k_new
        cache["v"][..., pos, :] = v_new
    if kind != "band":
        with _kind_span(kind, x.device):
            o = attn_lib.decode_window_attention(q, cache["k"], cache["v"], pos,
                                                 window=_layer_window(cfg, kind) or None)
    elif mode == "band":
        o = attn_lib.decode_band_attention(q, cache["k"], cache["v"], cfg.window_blocks, pos)
    else:
        o = attn_lib.decode_topk_attention(q, cache["k"], cache["v"],
                                           cfg.window_blocks if k_pages is None else k_pages, valid_len=pos + 1)
    x = x + (o.reshape(lead + (h * dh,)) @ params.wo).to(cfg.dtype)
    f_in = _norm(params, "ln2", x, cfg)
    if cfg.moe_route == "dropless":
        y = moe_lib.topk_moe_forward(params.moe, f_in.reshape(-1, cfg.d_model), cfg.moe_cfg())
        return x + y.reshape(f_in.shape)
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
    # The grouped MoE needs no topology; only the attention ones are built,
    # one per layer kind.
    kinds = {cfg.kind(i) for i in range(cfg.n_layers)}
    topos = {kind: _topology(cfg, kind, tp, device) for kind in kinds}
    ropes = _rope_by_kind(cfg, 0, tp, device)
    caches = init_decode_caches(cfg, max_len, device=device)
    x = params.embed[prompt.long()]
    for i, (cache, bp) in enumerate(zip(caches, params.blocks)):
        kind = cfg.kind(i)
        x, k, v = _attention_block(bp, x, pre_cfg, topos[kind], kind, ropes.get(kind))
        cache["k"][:, :tp] = k
        cache["v"][:, :tp] = v
        f_in = _norm(bp, "ln2", x, cfg)
        f_out, _ = _moe(bp.moe, f_in, cfg, pre_cfg.moe_cfg())
        x = x + f_out.to(cfg.dtype)
    x = _norm(params, "lnf", x, cfg)
    return caches, _logits(x[-1], _head(params, cfg))


@tracing.traced("decode_step", inputs=(1,))
@torch.no_grad()
def lm_decode_step(params: SparseLM, token: torch.Tensor, caches: Caches, pos,
                   cfg: TransformerConfig, *, mode: str = "band", k_pages: Optional[int] = None):
    """One decode step: token ids (...,) -> logits (..., vocab); the caches
    are updated in place and returned. ``pos`` is a host int, or for a
    model of full and sliding layers a 0-d integer tensor on the device."""
    x = params.embed[token.long()]
    ropes = _rope_by_kind(cfg, pos, None if isinstance(pos, torch.Tensor) else pos + 1, x.device)
    for i, (bp, cache) in enumerate(zip(params.blocks, caches)):
        kind = cfg.kind(i)
        x = block_decode(bp, x, cfg, cache, pos, mode=mode, k_pages=k_pages, kind=kind, rope=ropes.get(kind))
    x = _norm(params, "lnf", x, cfg)
    return _logits(x, _head(params, cfg)), caches


class DecodeGraph:
    """:func:`lm_decode_step` of ``batch`` sequences over caches of
    ``max_len`` positions, captured once as a CUDA graph and replayed for
    every step: the token ids and the position are inputs on the device, so
    the step's shapes do not depend on the position, and one replay issues
    the whole step (some 2,400 kernels for Mellum2's 28 layers) at the cost
    of one launch from the host. The graph reads :attr:`caches`
    ((batch, H_kv, max_len, dh) a layer, filled by :meth:`load`) and the
    parameters in place: it stays valid while their storage does, across
    new values written into it.

    Only for models whose every layer is ``full`` or ``sliding`` on the
    dropless MoE route, where a step reads nothing back to the host
    (:func:`graphable`). Attention then runs over a span fixed by the
    layer kind and masked to the keys the step attends (a sliding layer's
    ``window`` keys ending at ``pos``, a full layer's whole cache), the
    same keys and the same rounding as the eager step; the sums over the
    masked keys add zeros in another order."""

    def __init__(self, params: SparseLM, cfg: TransformerConfig, batch: int, max_len: int):
        device = params.embed.device
        shape = (batch, cfg.kv_heads, max_len, cfg.d_head)
        self.caches = [{name: torch.zeros(shape, dtype=cfg.dtype, device=device) for name in ("k", "v")}
                       for _ in range(cfg.n_layers)]
        self.token = torch.zeros(batch, dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)

        def step():
            return lm_decode_step(params, self.token, self.caches, self.pos, cfg)[0]

        # Run the step twice on a side stream before the capture (the
        # libraries' handles and workspaces are made outside the graph).
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = step()

    def load(self, per_seq) -> None:
        """Copy the caches of each sequence's prefill ([(caches, logits)],
        one a batch row) into :attr:`caches`."""
        for layer, cache in enumerate(self.caches):
            for name in ("k", "v"):
                torch.stack([c[layer][name] for c, _ in per_seq], out=cache[name])

    def step(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        """The logits (batch, vocab) of one step at ``pos``; they live in
        the graph's output, which the next step overwrites."""
        self.token.copy_(token)
        self.pos.fill_(pos)
        self.graph.replay()
        return self.logits


def graphable(cfg: TransformerConfig, device: torch.device, mode: str = "band", k_pages: Optional[int] = None) -> bool:
    """Whether the decode steps of ``cfg`` on ``device`` replay a
    :class:`DecodeGraph`: a card, every layer ``full`` or ``sliding``, the
    dropless MoE route, the band mode, and no profiler recording (a traced
    step runs eagerly, so that its spans and counters see every layer)."""
    return (device.type == "cuda" and cfg.moe_route == "dropless" and mode == "band" and k_pages is None
            and all(cfg.kind(i) != "band" for i in range(cfg.n_layers)) and not tracing.recording())


def _decode_graph(params: SparseLM, cfg: TransformerConfig, batch: int, max_len: int) -> DecodeGraph:
    """The model's :class:`DecodeGraph` for (``cfg``, ``batch``,
    ``max_len``), captured on first use and kept on the module."""
    graphs = params.__dict__.setdefault("_decode_graphs", {})
    key = (cfg, batch, max_len)
    if key not in graphs:
        graphs[key] = DecodeGraph(params, cfg, batch, max_len)
    return graphs[key]


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
                  generator: Optional[torch.Generator] = None, graph: Optional[DecodeGraph] = None) -> torch.Tensor:
    """The decode loop after prefill: pick a token from ``first_logits``
    (B, vocab), then ``n_new - 1`` steps at positions ``tp``, ``tp + 1``, ...
    (the caches are updated in place), each a replay of ``graph`` when
    given (its caches loaded; ``caches`` is then not read). Returns (B,
    n_new) token ids."""
    token = sample_tokens(first_logits, temperature, generator)
    tracing.mark("first_token", token.device, rows=token.numel())
    out = [token]
    for i in range(n_new - 1):
        if graph is not None:
            logits = graph.step(token, tp + i)
        else:
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
    key. The steps of a model of full and sliding layers on a card replay
    a :class:`DecodeGraph` (:func:`graphable`). Returns (B, n_new) token
    ids."""
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
        first = torch.stack([logits for _, logits in per_seq])
        graph = None
        if n_new > 1 and graphable(cfg, prompts.device, mode, k_pages):
            graph = _decode_graph(params, cfg, bsz, max_len)
            graph.load(per_seq)
            caches = graph.caches
        else:
            caches = [
                {name: torch.stack([c[layer][name] for c, _ in per_seq]) for name in ("k", "v")}
                for layer in range(cfg.n_layers)
            ]
        del per_seq
        return decode_tokens(params, first, caches, tp, cfg, n_new, mode=mode, k_pages=k_pages,
                             temperature=temperature, generator=generator, graph=graph)


def lm_generate(params: SparseLM, prompt: torch.Tensor, cfg: TransformerConfig, n_new: int, *,
                max_len: Optional[int] = None, mode: str = "band", k_pages: Optional[int] = None,
                temperature: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Generation for one prompt (Tp,); returns (n_new,) token ids."""
    return lm_generate_batched(params, prompt[None], cfg, n_new, max_len=max_len, mode=mode, k_pages=k_pages,
                               temperature=temperature, generator=generator)[0]
