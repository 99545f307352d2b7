"""Subgraph readout (ResPool).

Only center pooling with ``residue=none`` for the node task is ported:
the readout is the last conv layer's row at each subgraph's target, and
it has no parameters and no dropout (reference ``layers.py:161-163``;
the JAX ResPool returns before its MLP, so ``dropout`` never applies).
Every other readout raises at construction.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class ResPool(nn.Module):
    def __init__(self, type_res: str, type_pool: str, prediction_task: str):
        super().__init__()
        if (type_pool, type_res, prediction_task) != ("center", "none", "node"):
            raise NotImplementedError(
                f"ResPool {type_pool}/{type_res} for the {prediction_task} task "
                "is not ported yet (only center/none, node task)")

    def forward(self, feats_l: Sequence[torch.Tensor],
                targets: torch.Tensor) -> torch.Tensor:
        """feats_l: per-conv-layer [B, N, F]; targets [B, 1] -> [B, F]."""
        feat = feats_l[-1]
        idx = targets[..., None].expand(-1, -1, feat.shape[-1])
        return torch.gather(feat, 1, idx).reshape(-1, feat.shape[-1])
