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
* GCN — dropout, ``A_sym @ x``, one linear, act, norm;
* GIN — ``A_gin @ x + (1 + eps) x``, linear, relu, linear, act, norm
  (``eps`` a parameter of shape [1], initialised to 0);
* GATScatter — the DGL-style GAT: raw ``w_src``/``w_dst`` [in, out] and
  biases, one attention vector [1, H, dh] on the source features only
  (``att_self = 0``), the same masked softmax aggregation, then
  ``act(aggregate + x @ w_dst + b_dst)`` and a norm over [dim];
* MLP — linear -> act -> norm (none for the link task's classifier),
  ignoring the adjacency; as a conv (``MLPConv``) the layer of the
  ``mlp``, ``sgc`` and ``sign`` backbones;
* the norm of a conv (``norm``) — ``norm_feat``, ``pairnorm`` (the
  corrected PairNorm-SI of :func:`pairnorm`, which needs the node mask
  and has no parameters) or ``none``; GAT takes pairnorm flat, on the
  aggregate and on the self term;
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
  operands to bf16 and sums in f32; ``"tensorfloat32"`` runs the linears
  on TF32 tensor cores on a card (f32 on the CPU); both run the
  attention at its bf16 levels (``ops/precision.py``).

SAGE, GCN and GIN aggregate through a callable ``agg(x) -> A @ x``: a
dense ``torch.bmm`` on the uncached path, or the packed kernel
(``ops/packed.py``) on cached batches.  GAT and GATScatter take the pair
``(adj_norm, adj_struct)`` of dense blocks; the MLP conv takes nothing.
Every conv is called as ``conv(feat, agg, generator=None,
node_mask=None)``; SAGE also takes ``rows`` ([B, T]), the only rows of
its output that its caller reads, and then computes its linears, norms
and activations at those rows alone (:meth:`SAGEConv.forward`).
``norm_feat``'s backward is autograd's; the JAX package's custom VJP
computes the same gradients in fewer passes.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from shadow_gnn_torch.ops.gat import gat_attention
from shadow_gnn_torch.ops.precision import ROUNDED_PRECISIONS, bf16_head_dot, matmul


class TorchLinear(nn.Linear):
    """torch's nn.Linear (weight [out, in], U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) init for weight and bias), which the JAX
    ``TorchLinear`` reproduces, used as that one is: the parameters are
    cast to the input's dtype, the bias added after the product; an f32
    input at another ``precision`` than float32 takes that precision's
    product."""

    def __init__(self, dim_in: int, dim_out: int, precision: str = "float32"):
        super().__init__(dim_in, dim_out)
        self.precision = precision

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 and self.precision == "float32":
            return nn.functional.linear(x, self.weight, self.bias)
        if x.dtype == torch.float32:
            y = matmul(x.reshape(-1, x.shape[-1]), self.weight.t(), self.precision)
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


def xavier_normal_std(shape, gain: float) -> float:
    """Standard deviation of the JAX GATScatter's xavier-normal draw:
    gain * sqrt(2 / (fan_in + fan_out)), fan_in = shape[0], fan_out =
    shape[-1]."""
    return gain * math.sqrt(2.0 / (shape[0] + shape[-1]))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator):
    """Re-draw every linear layer's weight and bias from ``generator``
    with nn.Linear's default distribution, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), every GAT attention vector glorot-uniform, and
    GATScatter's ``w_src``, ``w_dst`` and attention xavier-normal (its
    biases 0); norm scales stay 1, offsets 0, GIN's eps 0 and PReLU
    slopes 0.25."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / m.in_features ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, GATConv):
            bound = glorot_bound(m.attention.shape)
            m.attention.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, GATScatterConv):
            for w in (m.w_src, m.w_dst, m.attention):
                w.normal_(0.0, xavier_normal_std(w.shape, m.gain),
                          generator=generator)
            m.b_src.zero_()
            m.b_dst.zero_()


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


def gather_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x [B, N, F], rows [B, T] -> x's rows [B, T, F]."""
    return torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[-1]))


def norm_feat(feat: torch.Tensor, scale: torch.Tensor,
              offset: torch.Tensor) -> torch.Tensor:
    """Per-row affine layernorm."""
    f32 = feat.float()
    mean = f32.mean(-1, keepdim=True)
    var = ((f32 - mean) ** 2).mean(-1, keepdim=True) + 1e-9
    return ((f32 - mean) * scale * torch.rsqrt(var) + offset).to(feat.dtype)


def pairnorm(feat: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """PairNorm-SI per subgraph block (the JAX package's corrected form):
    centre each column over the subgraph's valid rows, then scale each
    row to unit L2 norm (1e-12 under the square root); a row whose
    centred values are all zero passes through unchanged; padding rows
    come out zero.  feat [B, N, F], node_mask [B, N]."""
    m = node_mask[..., None].to(feat.dtype)
    cnt = torch.clamp(m.sum(-2, keepdim=True), min=1.0)
    mean = (feat * m).sum(-2, keepdim=True) / cnt
    centered = (feat - mean) * m
    null = centered.abs().sum(-1, keepdim=True) == 0
    centered = torch.where(null, feat, centered)
    norm = torch.sqrt((centered ** 2).sum(-1, keepdim=True) + 1e-12)
    return centered / norm * m


NORMS = ("norm_feat", "pairnorm", "none")


class _ConvBase(nn.Module):
    """A conv's dropout rate and norm choice: ``norm_feat`` owns
    ``scale``/``offset`` of ``norm_shape``; ``pairnorm`` and ``none``
    have no parameters."""

    def __init__(self, dropout: float, norm: str, norm_shape):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown layer norm {norm!r}")
        self.dropout = dropout
        self.norm = norm
        if norm == "norm_feat":
            self.scale = nn.Parameter(torch.ones(norm_shape))
            self.offset = nn.Parameter(torch.zeros(norm_shape))

    def _drop(self, feat, generator):
        return dropout(feat, self.dropout, generator) if self.training else feat

    def _norm(self, feat: torch.Tensor, node_mask: Optional[torch.Tensor],
              i: Optional[int] = None) -> torch.Tensor:
        """The norm over the last axis (``norm_feat`` with the ``i``-th
        slice of the norm parameters when ``i`` is given)."""
        if self.norm == "none":
            return feat
        if self.norm == "pairnorm":
            if node_mask is None:
                raise ValueError("pairnorm needs the node mask")
            return pairnorm(feat, node_mask)
        if i is None:
            return norm_feat(feat, self.scale, self.offset)
        return norm_feat(feat, self.scale[i], self.offset[i])


class SAGEConv(_ConvBase):
    def __init__(self, dim_in: int, dim_out: int, act: str = "relu",
                 dropout: float = 0.0, precision: str = "float32",
                 norm: str = "norm_feat"):
        super().__init__(dropout, norm, (2, dim_out))
        self.act = Act(act, dim_out)
        self.lin_self = TorchLinear(dim_in, dim_out, precision)
        self.lin_neigh = TorchLinear(dim_in, dim_out, precision)

    def forward(self, feat: torch.Tensor, agg: Callable,
                generator: Optional[torch.Generator] = None,
                node_mask: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One dropout draw on the input feeds both linears and the
        aggregation (in training mode only).  With ``rows`` [B, T] the
        dropout and the aggregation still cover the whole [B, N] block,
        then both linears, activations and norms run at those rows alone:
        [B, T, dim], the same rows of the full output."""
        if rows is not None and self.norm == "pairnorm":
            raise ValueError("pairnorm reads every row: no rows")
        take = (lambda x: x) if rows is None else (lambda x: gather_rows(x, rows))
        feat = self._drop(feat, generator)
        h_self = self.act(self.lin_self(take(feat)))
        h_neigh = self.act(self.lin_neigh(take(agg(feat))))
        return self._norm(h_self, node_mask, 0) + self._norm(h_neigh, node_mask, 1)


class GCNConv(_ConvBase):
    def __init__(self, dim_in: int, dim_out: int, act: str = "relu",
                 dropout: float = 0.0, precision: str = "float32",
                 norm: str = "norm_feat"):
        super().__init__(dropout, norm, (dim_out,))
        self.act = Act(act, dim_out)
        self.lin = TorchLinear(dim_in, dim_out, precision)

    def forward(self, feat: torch.Tensor, agg: Callable,
                generator: Optional[torch.Generator] = None,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """act(lin(A_sym @ dropout(x))), then the norm."""
        feat = self._drop(feat, generator)
        return self._norm(self.act(self.lin(agg(feat))), node_mask)


class GINConv(_ConvBase):
    def __init__(self, dim_in: int, dim_out: int, act: str = "relu",
                 dropout: float = 0.0, precision: str = "float32",
                 norm: str = "norm_feat"):
        super().__init__(dropout, norm, (dim_out,))
        self.act = Act(act, dim_out)
        self.eps = nn.Parameter(torch.zeros(1))
        self.lin1 = TorchLinear(dim_in, dim_out, precision)
        self.lin2 = TorchLinear(dim_out, dim_out, precision)
        # the relu between the two linears (a module, so that it can be
        # told apart from the conv's own activation)
        self.inner_act = Act("relu")

    def forward(self, feat: torch.Tensor, agg: Callable,
                generator: Optional[torch.Generator] = None,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """act(lin2(relu(lin1(A_gin @ x + (1 + eps) x)))), then the norm;
        an f32 ``eps`` makes a bf16 block f32, as in JAX."""
        feat = self._drop(feat, generator)
        h = self.lin1(agg(feat) + (1.0 + self.eps) * feat)
        return self._norm(self.act(self.lin2(self.inner_act(h))), node_mask)


class GATConv(_ConvBase):
    """Multi-head GAT over dense blocks.  The flat feature index of the
    linears' outputs is ``head * dh + d``."""

    def __init__(self, dim_in: int, dim_out: int, heads: int, act: str = "relu",
                 dropout: float = 0.0, precision: str = "float32",
                 norm: str = "norm_feat"):
        if dim_out % heads:
            raise ValueError(f"dim {dim_out} is not a multiple of {heads} heads")
        shape = (2, heads, dim_out // heads)
        super().__init__(dropout, norm, shape)
        self.heads = heads
        self.act = Act(act, dim_out)
        self.precision = precision
        self.lin_self = TorchLinear(dim_in, dim_out, precision)
        self.lin_neigh = TorchLinear(dim_in, dim_out, precision)
        self.attention = nn.Parameter(torch.empty(shape))
        nn.init.uniform_(self.attention, -glorot_bound(shape), glorot_bound(shape))

    def forward(self, feat: torch.Tensor, adjs: Tuple[torch.Tensor, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """adjs: (adj_norm, adj_struct) [B, N, N] f32; one dropout draw on
        the input (training mode only), no dropout on the attention.  The
        attention runs at its bf16 levels (both) under bf16 precision or
        on bf16 values, as layers.py:501-508 decides; its f32 output is
        cast back to the input's dtype.  ``norm_feat`` normalises each
        head (``scale[0]`` the aggregate, ``scale[1]`` the self term),
        ``pairnorm`` the flat [B, N, H * dh] rows."""
        adj_norm, adj_struct = adjs
        feat = self._drop(feat, generator)
        b, n, _ = feat.shape
        shape = (b, n, self.heads, -1)
        h_self = self.act(self.lin_self(feat)).view(shape)
        h_neigh = self.act(self.lin_neigh(feat)).view(shape)
        dot = (bf16_head_dot if self.precision == "bfloat16"
               else lambda x, a: torch.einsum("bnhd,hd->bhn", x, a))
        att = [torch.nn.functional.leaky_relu(dot(x.float(), self.attention[k]), 0.2)
               for k, x in enumerate((h_self, h_neigh))]
        bf16 = (self.precision in ROUNDED_PRECISIONS
                or h_neigh.dtype == torch.bfloat16)
        aggr = gat_attention(att[0], att[1], h_neigh, adj_norm, adj_struct,
                             bf16, bf16).to(feat.dtype)
        if self.norm == "norm_feat":
            aggr, h_self = self._norm(aggr, None, 0), self._norm(h_self, None, 1)
        aggr, h_self = aggr.reshape(b, n, -1), h_self.reshape(b, n, -1)
        if self.norm == "pairnorm":
            aggr, h_self = self._norm(aggr, node_mask), self._norm(h_self, node_mask)
        return (h_self + aggr) / 2.0


class GATScatterConv(_ConvBase):
    """The DGL-style GAT variant (JAX ``GATScatterConv``, its fused flat
    path): the score of edge (i, j) is ``leaky_relu(feat_src[j] . att,
    0.2)``, which depends on the source alone, so the aggregate is
    :func:`gat_attention` with ``att_self = 0``."""

    def __init__(self, dim_in: int, dim_out: int, heads: int, act: str = "relu",
                 dropout: float = 0.0, precision: str = "float32",
                 norm: str = "norm_feat"):
        if dim_out % heads:
            raise ValueError(f"dim {dim_out} is not a multiple of {heads} heads")
        super().__init__(dropout, norm, (dim_out,))
        self.heads = heads
        self.act = Act(act, dim_out)
        self.precision = precision
        self.gain = math.sqrt(2.0) if act == "relu" else 1.0
        self.w_src = nn.Parameter(torch.empty(dim_in, dim_out))
        self.b_src = nn.Parameter(torch.zeros(dim_out))
        self.w_dst = nn.Parameter(torch.empty(dim_in, dim_out))
        self.b_dst = nn.Parameter(torch.zeros(dim_out))
        self.attention = nn.Parameter(torch.empty(1, heads, dim_out // heads))
        for w in (self.w_src, self.w_dst, self.attention):
            nn.init.normal_(w, 0.0, xavier_normal_std(w.shape, self.gain))

    def _affine(self, x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        """``x @ w + bias`` as JAX takes it: a bf16 ``x`` is promoted to
        the f32 parameters' dtype; an f32 product at the layer's precision."""
        x = x.to(torch.promote_types(x.dtype, w.dtype))
        if self.precision != "float32" and x.dtype == torch.float32:
            y = matmul(x.reshape(-1, x.shape[-1]), w, self.precision)
            return y.reshape(x.shape[:-1] + (-1,)) + bias
        return x @ w + bias

    def forward(self, feat: torch.Tensor, adjs: Tuple[torch.Tensor, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """adjs: (adj_norm, adj_struct) [B, N, N] f32.  The scores' head
        dot stays f32 (JAX's ``_head_dot`` runs at HIGHEST precision);
        the attention runs at its bf16 levels under bf16 or TF32
        precision, as ``_fused_attention_flat`` decides."""
        adj_norm, adj_struct = adjs
        x = self._drop(feat, generator)
        b, n, _ = x.shape
        feat_src = self._affine(x, self.w_src, self.b_src)
        v = feat_src.view(b, n, self.heads, -1)
        el = torch.nn.functional.leaky_relu(
            torch.einsum("bnhd,hd->bhn", v.float(), self.attention[0]), 0.2)
        bf16 = (self.precision in ROUNDED_PRECISIONS
                or feat_src.dtype == torch.bfloat16)
        aggr = gat_attention(torch.zeros_like(el), el, v, adj_norm, adj_struct,
                             bf16, bf16).reshape(b, n, -1).to(x.dtype)
        out = self.act(aggr + self._affine(x, self.w_dst, self.b_dst))
        return self._norm(out, node_mask)


class MLPLayer(_ConvBase):
    """MLP layer (the classifier stack): linear -> act -> norm, where
    ``norm="none"`` (the link task's classifier) skips the norm and has
    no norm parameters."""

    def __init__(self, dim_in: int, dim_out: int, act: str = "relu",
                 dropout: float = 0.0, precision: str = "float32",
                 norm: str = "norm_feat"):
        super().__init__(dropout, norm, (dim_out,))
        self.act = Act(act, dim_out)
        self.lin = TorchLinear(dim_in, dim_out, precision)

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        feat = self._drop(feat, generator)
        return self._norm(self.act(self.lin(feat)), node_mask)


class MLPConv(MLPLayer):
    """The layer of the adjacency-free backbones (``mlp``, ``sgc``,
    ``sign``, whose propagation ran in the preprocessing): an
    :class:`MLPLayer` with a conv's signature, ignoring ``agg``."""

    def forward(self, feat: torch.Tensor, agg=None,
                generator: Optional[torch.Generator] = None,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return super().forward(feat, generator, node_mask)


# the conv of each backbone (the JAX package's NAME2LAYER); the
# attention convs take ``heads`` too
NAME2LAYER = {"mlp": MLPConv, "gcn": GCNConv, "gin": GINConv, "sage": SAGEConv,
              "gat": GATConv, "gatscat": GATScatterConv, "sgc": MLPConv,
              "sign": MLPConv}
ATTENTION = ("gat", "gatscat")
