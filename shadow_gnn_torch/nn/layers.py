"""GNN layers over padded dense subgraph blocks (torch.nn).

Numerics follow the JAX package's ``nn/layers.py`` (and through it the
reference ``shaDow/layers.py``):

* ``norm_feat`` — per-row affine layernorm, biased variance + 1e-9
  inside the rsqrt, statistics in float32;
* SAGE — self and rw-normalised neighbour linears, activation *before*
  the norm, separate norm slices ``scale[0]``/``scale[1]``, summed;
* GAT — per-head additive attention (the dense branch of the JAX
  ``GATConv``): activation before attention, leaky-ReLU(0.2) scores,
  the masked softmax aggregation of ``ops/gat.py``, per-head norms
  (``scale[0]`` on the aggregate, ``scale[1]`` on the self term, the
  opposite of SAGE's order), ``(self + aggregate) / 2``;
* MLP — linear -> act -> norm (none for the link task's classifier),
  ignoring the adjacency;
* activations — ``Act`` owns PReLU's slope (``prelu``: one, ``prelu+``:
  one per channel, both initialised to 0.25); one ``Act`` serves both
  linears of a conv, as the flax module ``Act_0`` does;
* dropout (``_ConvBase._dropout``) — in training, once on each layer's
  input: ``where(keep, x / (1 - p), 0)`` with ``keep`` drawn from an
  explicit ``torch.Generator``;
* dtypes — a linear casts its f32 weights to its input's dtype
  (``TorchLinear``, layers.py:148), so bf16 activations give bf16
  outputs; elsewhere PyTorch's type promotion follows JAX's (a bf16
  block times an f32 parameter, such as PReLU's slope, is f32);
* ``precision="bfloat16"`` (``--matmul_precision bfloat16``) — each f32
  product (the linears, GAT's attention-vector contraction) rounds its
  operands to bf16 and sums in f32 (``ops/precision.py``).

SAGE aggregates through a callable ``agg(x) -> A @ x``: a dense
``torch.bmm`` on the uncached path, or the packed kernel
(``ops/packed.py``) on cached batches.  GAT takes the pair
``(adj_norm, adj_struct)`` of dense blocks.  ``norm_feat``'s backward
is autograd's; the JAX package's custom VJP computes the same gradients
in fewer passes.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from shadow_gnn_torch.ops.gat import gat_attention
from shadow_gnn_torch.ops.precision import bf16_head_dot, bf16_matmul

PRECISIONS = ("float32", "bfloat16")


class TorchLinear(nn.Linear):
    """torch's nn.Linear (weight [out, in], U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) init for weight and bias), which the JAX
    ``TorchLinear`` reproduces, used as that one is: the parameters are
    cast to the input's dtype, the bias added after the product; an f32
    input at ``precision="bfloat16"`` takes the bf16-precision product."""

    def __init__(self, dim_in: int, dim_out: int, precision: str = "float32"):
        super().__init__(dim_in, dim_out)
        self.precision = precision

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 and self.precision == "float32":
            return nn.functional.linear(x, self.weight, self.bias)
        if x.dtype == torch.float32:
            y = bf16_matmul(x.reshape(-1, x.shape[-1]), self.weight.t())
            y = y.reshape(x.shape[:-1] + (-1,))
        else:
            y = nn.functional.linear(x, self.weight.to(x.dtype))
        return y + self.bias.to(y.dtype)


def glorot_bound(shape) -> float:
    """Bound of flax's ``glorot_uniform`` for ``shape``: fans over the
    last two axes times the product of the others (the receptive
    field), U(-sqrt(6 / (fan_in + fan_out)), +...)."""
    field = math.prod(shape[:-2])
    return math.sqrt(6.0 / (shape[-2] * field + shape[-1] * field))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator):
    """Re-draw every linear layer's weight and bias from ``generator``
    with nn.Linear's default distribution, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), and every GAT attention vector glorot-uniform;
    norm scales stay 1, offsets 0 and PReLU slopes 0.25."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / m.in_features ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, GATConv):
            bound = glorot_bound(m.attention.shape)
            m.attention.uniform_(-bound, bound, generator=generator)


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The parameter-free activations (reference F_ACT registry)."""
    if name == "relu":
        return torch.relu
    if name == "I":
        return lambda x: x
    if name == "elu":
        return torch.nn.functional.elu
    if name == "tanh":
        return torch.tanh
    if name == "leakyrelu":
        return lambda x: torch.nn.functional.leaky_relu(x, 0.2)
    raise NotImplementedError(f"activation {name!r} is not ported yet")


class Act(nn.Module):
    """An activation as a module, so that PReLU owns its slope:
    ``prelu`` one slope, ``prelu+`` one per output channel (torch PReLU's
    init 0.25); every other name is :func:`get_act`'s."""

    def __init__(self, name: str, dim_out: int = 1):
        super().__init__()
        self.name = name
        if name in ("prelu", "prelu+"):
            n = dim_out if name == "prelu+" else 1
            self.prelu_alpha = nn.Parameter(torch.full((n,), 0.25))
        else:
            self.fn = get_act(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.name in ("prelu", "prelu+"):
            return torch.where(x > 0, x, self.prelu_alpha * x)
        return self.fn(x)


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
                 dropout: float = 0.0, precision: str = "float32"):
        super().__init__()
        self.act = Act(act, dim_out)
        self.dropout = dropout
        self.lin_self = TorchLinear(dim_in, dim_out, precision)
        self.lin_neigh = TorchLinear(dim_in, dim_out, precision)
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


class GATConv(nn.Module):
    """Multi-head GAT over dense blocks.  The flat feature index of the
    linears' outputs is ``head * dh + d``."""

    def __init__(self, dim_in: int, dim_out: int, heads: int, act: str = "relu",
                 dropout: float = 0.0, precision: str = "float32"):
        super().__init__()
        if dim_out % heads:
            raise ValueError(f"dim {dim_out} is not a multiple of {heads} heads")
        self.heads = heads
        self.act = Act(act, dim_out)
        self.dropout = dropout
        self.precision = precision
        self.lin_self = TorchLinear(dim_in, dim_out, precision)
        self.lin_neigh = TorchLinear(dim_in, dim_out, precision)
        shape = (2, heads, dim_out // heads)
        self.attention = nn.Parameter(torch.empty(shape))
        nn.init.uniform_(self.attention, -glorot_bound(shape), glorot_bound(shape))
        self.scale = nn.Parameter(torch.ones(shape))
        self.offset = nn.Parameter(torch.zeros(shape))

    def forward(self, feat: torch.Tensor, adjs: Tuple[torch.Tensor, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """adjs: (adj_norm, adj_struct) [B, N, N] f32; one dropout draw on
        the input (training mode only), no dropout on the attention.  The
        attention runs at its bf16 levels (both) under bf16 precision or
        on bf16 values, as layers.py:501-508 decides; its f32 output is
        cast back to the input's dtype."""
        adj_norm, adj_struct = adjs
        if self.training:
            feat = dropout(feat, self.dropout, generator)
        b, n, _ = feat.shape
        shape = (b, n, self.heads, -1)
        h_self = self.act(self.lin_self(feat)).view(shape)
        h_neigh = self.act(self.lin_neigh(feat)).view(shape)
        dot = (bf16_head_dot if self.precision == "bfloat16"
               else lambda x, a: torch.einsum("bnhd,hd->bhn", x, a))
        att = [torch.nn.functional.leaky_relu(dot(x.float(), self.attention[k]), 0.2)
               for k, x in enumerate((h_self, h_neigh))]
        bf16 = self.precision == "bfloat16" or h_neigh.dtype == torch.bfloat16
        aggr = gat_attention(att[0], att[1], h_neigh, adj_norm, adj_struct,
                             bf16, bf16).to(feat.dtype)
        aggr = norm_feat(aggr, self.scale[0], self.offset[0])
        h_self = norm_feat(h_self, self.scale[1], self.offset[1])
        return (h_self + aggr).reshape(b, n, -1) / 2.0


class MLPLayer(nn.Module):
    """MLP layer (the classifier stack): linear -> act -> norm, where
    ``norm="none"`` (the link task's classifier) skips the norm and has
    no norm parameters."""

    def __init__(self, dim_in: int, dim_out: int, act: str = "relu",
                 dropout: float = 0.0, precision: str = "float32",
                 norm: str = "norm_feat"):
        super().__init__()
        if norm not in ("norm_feat", "none"):
            raise ValueError(f"unknown MLP norm {norm!r}")
        self.act = Act(act, dim_out)
        self.dropout = dropout
        self.lin = TorchLinear(dim_in, dim_out, precision)
        self.norm = norm
        if norm == "norm_feat":
            self.scale = nn.Parameter(torch.ones(dim_out))
            self.offset = nn.Parameter(torch.zeros(dim_out))

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training:
            feat = dropout(feat, self.dropout, generator)
        h = self.act(self.lin(feat))
        return h if self.norm == "none" else norm_feat(h, self.scale, self.offset)
