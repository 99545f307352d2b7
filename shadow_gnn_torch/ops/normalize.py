"""Dense adjacency normalisation over [B, N, N] subgraph blocks.

Used by the uncached (dense) aggregation path and by the plain version
of the packed aggregation kernel.  Degrees are clipped at 1.  Dropedge
belongs to training and is not ported yet.
"""
from __future__ import annotations

import torch


def adj_norm_sym(adj: torch.Tensor) -> torch.Tensor:
    """Symmetric D^-1/2 A D^-1/2."""
    d_inv_sqrt = torch.rsqrt(torch.clamp(adj.sum(-1), min=1.0))
    return adj * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]


def adj_norm_rw(adj: torch.Tensor) -> torch.Tensor:
    """Random-walk D^-1 A: every edge of row i gets 1/deg(i)."""
    return adj / torch.clamp(adj.sum(-1), min=1.0)[..., :, None]
