"""Models of the port: block-sparse attention, the MoE FFN and the sparse LM."""

from sputnik_tpu_torch.models.attention import (
    band_topology,
    block_sparse_attention,
    causal_block_topology,
    decode_band_attention,
    multihead_block_sparse_attention,
)
from sputnik_tpu_torch.models.convert import params_from_numpy
from sputnik_tpu_torch.models.moe import MoE, MoEConfig, block_diag_topology, init_moe_params, moe_forward
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
    lm_prefill,
    lm_topologies,
)

__all__ = [
    "band_topology", "block_sparse_attention", "causal_block_topology", "decode_band_attention",
    "multihead_block_sparse_attention", "params_from_numpy", "MoE", "MoEConfig",
    "block_diag_topology", "init_moe_params", "moe_forward", "Block", "SparseLM",
    "TransformerConfig", "block_decode", "block_forward", "init_decode_caches", "init_lm_params",
    "lm_decode_step", "lm_forward", "lm_generate", "lm_generate_batched", "lm_prefill",
    "lm_topologies",
]
