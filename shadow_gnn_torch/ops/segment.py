"""Masked pooling over padded subgraph blocks.

feat [B, N, F] with a node mask [B, N] (bool) -> [B, F]: padding rows
never contribute to a sum, a mean, a maximum or a sort's ranking.  The
counterpart of ``shadow_gnn_tpu/ops/segment.py``.
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


def masked_sort_pool(feat: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """PyG ``global_sort_pool``: each graph's nodes in descending order of
    the last channel (a stable sort, as ``jnp.argsort``: ties keep the
    lower index first; padding rows rank last), the top k rows
    concatenated to [B, k*F].  A graph with fewer than k valid nodes
    gets zero rows."""
    b, n, f = feat.shape
    key = torch.where(mask, feat[..., -1], _NEG)
    order = torch.sort(-key, dim=-1, stable=True)[1][:, :k]             # [B, k]
    if order.shape[1] < k:
        order = torch.nn.functional.pad(order, (0, k - order.shape[1]))
    top = torch.gather(feat, 1, order[..., None].expand(-1, -1, f))      # [B, k, F]
    rank_valid = torch.arange(k, device=feat.device)[None, :] < mask.sum(-1, keepdim=True)
    return (top * rank_valid[..., None]).reshape(b, k * f)
