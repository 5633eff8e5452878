"""DLMC-protocol sparse matrices: magnitude pruning of the trained weights
(``sputnik_tpu/utils/dlmc_gen.py``, its pruning and loading part).

``data/dlmc_weights.npz`` holds the trained dense weight matrices of the
DLMC-protocol transformer (d_model 512, d_ff 2048); consumers prune them at
load time (:func:`pruned_csr`) at the DLMC sparsities 70-98%. Training the
weights (``train_weights``, with JAX and optax) stays in the JAX package.
"""

from __future__ import annotations

import numpy as np

from sputnik_tpu_torch.formats import CsrMatrix, csr_from_dense

__all__ = ["D_MODEL", "D_FF", "SEQ", "SPARSITIES", "WEIGHT_KEYS", "magnitude_prune", "pruned_csr",
           "load_weights", "load_provenance"]

D_MODEL = 512
D_FF = 2048
SEQ = 256

SPARSITIES = (0.70, 0.80, 0.90, 0.95, 0.98)

# The DLMC-shaped matrices harvested from the trained model.
WEIGHT_KEYS = (
    "attn_q",  # (512, 512)
    "attn_o",  # (512, 512)
    "ffn_w1",  # (512, 2048)
    "ffn_w2",  # (2048, 512)
)


def magnitude_prune(w: np.ndarray, sparsity: float) -> np.ndarray:
    """Zero the smallest-|w| entries globally (the DLMC pruning rule)."""
    flat = np.abs(w).ravel()
    k = int(round(len(flat) * sparsity))
    if k <= 0:
        return w.copy()
    thresh = np.partition(flat, k - 1)[k - 1]
    out = w.copy()
    out[np.abs(out) <= thresh] = 0.0
    return out


def pruned_csr(weights: dict, name: str, sparsity: float, *, device=None) -> CsrMatrix:
    """CsrMatrix of a trained weight matrix pruned at ``sparsity``, on
    ``device`` (``None``: the card)."""
    return csr_from_dense(magnitude_prune(weights[name], sparsity), device=device)


def load_weights(path: str) -> dict:
    """Weight matrices only (provenance keys like corpus_sha256 excluded)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k in WEIGHT_KEYS}


def load_provenance(path: str) -> dict:
    with np.load(path) as z:
        out = {}
        if "corpus_sha256" in z.files:
            out["corpus_sha256"] = z["corpus_sha256"].tobytes().decode()
        return out
