"""The update of a training step: the weighted cross-entropy loss, the
gradients' global-norm clip at 5 (no epsilon) and Adam (lr from the
configuration, betas 0.9 / 0.999, eps 1e-8, bias-corrected), as the
shaDow-GNN reference trains (``models.py``: loss, then the clip, then
the optimizer)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

CLIP = 5.0
BETAS = (0.9, 0.999)
EPS = 1e-8


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor, w: torch.Tensor):
    """(numerator, weight sum) of the rows' cross-entropy weighted by
    ``w`` (0 on an epoch's padding rows)."""
    logp = torch.log_softmax(logits, -1)
    rows = -logp.gather(1, labels[:, None])[:, 0]
    return (rows * w).sum(), w.sum()


def clip(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    coef = torch.where(norm >= CLIP, CLIP / norm, torch.ones_like(norm))
    return {k: g * coef for k, g in grads.items()}


class Adam:
    """Adam from its moments ``m``, ``v`` after ``t`` steps (none: a
    fresh one)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 m: Optional[Dict[str, torch.Tensor]] = None,
                 v: Optional[Dict[str, torch.Tensor]] = None, t: int = 0):
        self.lr, self.t = lr, t
        self.m = m if m is not None else {k: torch.zeros_like(x) for k, x in params.items()}
        self.v = v if v is not None else {k: torch.zeros_like(x) for k, x in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        b1, b2 = BETAS
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
            self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
            out[k] = p - self.lr * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + EPS)
        return out


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}
