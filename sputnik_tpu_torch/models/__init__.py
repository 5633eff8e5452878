"""Models of the port: block-sparse attention, the MoE FFN and the sparse LM."""

from sputnik_tpu_torch.models.attention import (
    band_topology,
    block_sparse_attention,
    causal_block_topology,
    decode_band_attention,
    decode_topk_attention,
    flash_block_attention,
    multihead_block_sparse_attention,
    topk_block_topology,
)
from sputnik_tpu_torch.models.convert import grads_to_numpy, params_from_numpy
from sputnik_tpu_torch.models.moe import (
    MoE,
    MoEConfig,
    block_diag_topology,
    dropless_moe_forward,
    dropless_topology,
    init_moe_params,
    moe_forward,
    moe_loss,
)
from sputnik_tpu_torch.models.transformer import (
    Block,
    SparseLM,
    TransformerConfig,
    block_decode,
    block_forward,
    init_decode_caches,
    init_lm_params,
    lm_decode_step,
    lm_forward,
    lm_generate,
    lm_generate_batched,
    lm_loss,
    lm_prefill,
    lm_topologies,
)

__all__ = [
    "band_topology", "block_sparse_attention", "causal_block_topology", "decode_band_attention",
    "decode_topk_attention", "flash_block_attention", "topk_block_topology", "multihead_block_sparse_attention", "params_from_numpy", "grads_to_numpy", "MoE", "MoEConfig",
    "block_diag_topology", "dropless_moe_forward", "dropless_topology", "init_moe_params",
    "moe_forward", "moe_loss", "Block", "SparseLM",
    "TransformerConfig", "block_decode", "block_forward", "init_decode_caches", "init_lm_params",
    "lm_decode_step", "lm_forward", "lm_generate", "lm_generate_batched", "lm_loss", "lm_prefill",
    "lm_topologies",
]
