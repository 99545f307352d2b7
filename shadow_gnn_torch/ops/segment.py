"""Masked pooling over padded subgraph blocks.

feat [B, N, F] with a node mask [B, N] (bool) -> [B, F]: padding rows
never contribute to a sum, a mean or a maximum.  The counterpart of
``shadow_gnn_tpu/ops/segment.py`` (sort pooling is not ported yet).
"""
from __future__ import annotations

import torch

_NEG = -1e30


def masked_sum_pool(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (feat * mask[..., None]).sum(-2)


def masked_mean_pool(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    cnt = torch.clamp(mask.sum(-1, keepdim=True).to(feat.dtype), min=1.0)
    return (feat * mask[..., None]).sum(-2) / cnt


def masked_max_pool(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Padding rows hold -1e30 for the max; a block with no valid row
    pools to 0.  ``amax`` shares the gradient among tied maxima, as JAX
    does."""
    out = torch.where(mask[..., None], feat, _NEG).amax(-2)
    return torch.where(out <= _NEG / 2, 0.0, out)
