"""GNN layers over padded dense subgraph blocks (torch.nn), forward only.

Numerics follow the JAX package's ``nn/layers.py`` (and through it the
reference ``shaDow/layers.py``):

* ``norm_feat`` — per-row affine layernorm, biased variance + 1e-9
  inside the rsqrt, statistics in float32;
* SAGE — self and rw-normalised neighbour linears, activation *before*
  the norm, separate norm slices ``scale[0]``/``scale[1]``, summed;
* MLP — linear -> act -> norm, ignoring the adjacency.

Aggregation is a callable ``agg(x) -> A @ x``: a dense ``torch.bmm`` on
the uncached path, or the packed kernel (``ops/packed.py``) on cached
batches.  Dropout belongs to training and is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

# JAX ``TorchLinear`` reproduces torch's nn.Linear (weight [out, in],
# U(-1/sqrt(fan_in), 1/sqrt(fan_in)) init for weight and bias).
TorchLinear = nn.Linear


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator):
    """Re-draw every linear layer's weight and bias from ``generator``
    with nn.Linear's default distribution, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)); norm scales stay 1 and offsets 0."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / m.in_features ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "relu":
        return torch.relu
    if name == "I":
        return lambda x: x
    raise NotImplementedError(f"activation {name!r} is not ported yet")


def norm_feat(feat: torch.Tensor, scale: torch.Tensor,
              offset: torch.Tensor) -> torch.Tensor:
    """Per-row affine layernorm (forward only)."""
    f32 = feat.float()
    mean = f32.mean(-1, keepdim=True)
    var = ((f32 - mean) ** 2).mean(-1, keepdim=True) + 1e-9
    return ((f32 - mean) * scale * torch.rsqrt(var) + offset).to(feat.dtype)


class SAGEConv(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, act: str = "relu"):
        super().__init__()
        self.act = get_act(act)
        self.lin_self = TorchLinear(dim_in, dim_out)
        self.lin_neigh = TorchLinear(dim_in, dim_out)
        self.scale = nn.Parameter(torch.ones(2, dim_out))
        self.offset = nn.Parameter(torch.zeros(2, dim_out))

    def forward(self, feat: torch.Tensor, agg: Callable) -> torch.Tensor:
        h_self = self.act(self.lin_self(feat))
        h_neigh = self.act(self.lin_neigh(agg(feat)))
        return (norm_feat(h_self, self.scale[0], self.offset[0])
                + norm_feat(h_neigh, self.scale[1], self.offset[1]))


class MLPLayer(nn.Module):
    """MLP layer (the classifier stack): linear -> act -> norm."""

    def __init__(self, dim_in: int, dim_out: int, act: str = "relu"):
        super().__init__()
        self.act = get_act(act)
        self.lin = TorchLinear(dim_in, dim_out)
        self.scale = nn.Parameter(torch.ones(dim_out))
        self.offset = nn.Parameter(torch.zeros(dim_out))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return norm_feat(self.act(self.lin(feat)), self.scale, self.offset)
