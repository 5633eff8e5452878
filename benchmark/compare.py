"""The numbers that decide ``correct``, from the program's readings and the
plain reference's.

Training: each of the first steps' loss, the first gradient's norm and the
parameters' change after the first steps, each by its worst leaf: the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change. Serving: by how much a
served token's reference logit lies below the reference's best, at its
widest or on average over the served tokens.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

GRAD_FLOOR = 1e-3


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves)


def train(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` / ``ref``: {"loss": [per step], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][n] for n in leaves)
    moving = [n for n in leaves if ref["grad"][n] >= GRAD_FLOOR * med]
    return {
        "loss_gap": loss_gap,
        "grad_gap": _worst_leaf(prog["grad"], ref["grad"], leaves),
        "change_gap": _worst_leaf(prog["change"], ref["change"], moving),
    }


def token_gaps(ref_logits: Sequence[torch.Tensor], served: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per served token, the gap between the reference's best logit and its
    logit of the served token (rows of ``ref_logits[i]`` chose
    ``served[i]``), all requests' tokens in one vector."""
    gaps = []
    for lg, tok in zip(ref_logits, served):
        lg = lg.float()
        gaps.append(lg.max(dim=-1).values - lg.gather(-1, tok.long().to(lg.device)[:, None])[:, 0])
    return torch.cat(gaps).cpu()


def argmax_tokens(low_logits: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tokens a lower-precision forward puts first at each position."""
    return [lg.argmax(dim=-1) for lg in low_logits]


def gap_stats(gaps: torch.Tensor) -> Dict[str, float]:
    """``logit_gap``: the widest gap; ``mean_logit_gap``: the mean over the
    served tokens."""
    return {"logit_gap": float(gaps.max()), "mean_logit_gap": float(gaps.mean())}

