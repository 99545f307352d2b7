"""GNN layers over padded dense subgraph blocks (torch.nn).

Numerics follow the JAX package's ``nn/layers.py`` (and through it the
reference ``shaDow/layers.py``):

* ``norm_feat`` — per-row affine layernorm, biased variance + 1e-9
  inside the rsqrt, statistics in float32;
* SAGE — self and rw-normalised neighbour linears, activation *before*
  the norm, separate norm slices ``scale[0]``/``scale[1]``, summed;
* MLP — linear -> act -> norm, ignoring the adjacency;
* dropout (``_ConvBase._dropout``) — in training, once on each layer's
  input: ``where(keep, x / (1 - p), 0)`` with ``keep`` drawn from an
  explicit ``torch.Generator``.

Aggregation is a callable ``agg(x) -> A @ x``: a dense ``torch.bmm`` on
the uncached path, or the packed kernel (``ops/packed.py``) on cached
batches.  ``norm_feat``'s backward is autograd's; the JAX package's
custom VJP computes the same gradients in fewer passes.
"""
from __future__ import annotations

from typing import Callable, Optional

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


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]
            ) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability 1 - p (mask
    drawn from ``generator``, on ``x``'s device) and scale it by
    1 / (1 - p).  The identity at p == 0."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


def norm_feat(feat: torch.Tensor, scale: torch.Tensor,
              offset: torch.Tensor) -> torch.Tensor:
    """Per-row affine layernorm."""
    f32 = feat.float()
    mean = f32.mean(-1, keepdim=True)
    var = ((f32 - mean) ** 2).mean(-1, keepdim=True) + 1e-9
    return ((f32 - mean) * scale * torch.rsqrt(var) + offset).to(feat.dtype)


class SAGEConv(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, act: str = "relu",
                 dropout: float = 0.0):
        super().__init__()
        self.act = get_act(act)
        self.dropout = dropout
        self.lin_self = TorchLinear(dim_in, dim_out)
        self.lin_neigh = TorchLinear(dim_in, dim_out)
        self.scale = nn.Parameter(torch.ones(2, dim_out))
        self.offset = nn.Parameter(torch.zeros(2, dim_out))

    def forward(self, feat: torch.Tensor, agg: Callable,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One dropout draw on the input feeds both linears and the
        aggregation (in training mode only)."""
        if self.training:
            feat = dropout(feat, self.dropout, generator)
        h_self = self.act(self.lin_self(feat))
        h_neigh = self.act(self.lin_neigh(agg(feat)))
        return (norm_feat(h_self, self.scale[0], self.offset[0])
                + norm_feat(h_neigh, self.scale[1], self.offset[1]))


class MLPLayer(nn.Module):
    """MLP layer (the classifier stack): linear -> act -> norm."""

    def __init__(self, dim_in: int, dim_out: int, act: str = "relu",
                 dropout: float = 0.0):
        super().__init__()
        self.act = get_act(act)
        self.dropout = dropout
        self.lin = TorchLinear(dim_in, dim_out)
        self.scale = nn.Parameter(torch.ones(dim_out))
        self.offset = nn.Parameter(torch.zeros(dim_out))

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training:
            feat = dropout(feat, self.dropout, generator)
        return norm_feat(self.act(self.lin(feat)), self.scale, self.offset)
