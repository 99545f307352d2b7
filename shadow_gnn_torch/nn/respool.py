"""Subgraph readout (ResPool) for the node and link tasks.

Reference ``layers.py:57-233`` through the JAX package's
``nn/respool.py``: a residue over the conv layers' outputs (none, sum,
max, concat) and a pooling (center, mean, max, sum, sort-k).  The
targets' rows are gathered; the link task (two targets a subgraph)
combines them as src (*) dst (layers.py:145-152).  Center pooling with
no residue on the node task is the last layer's row at each target and
has no parameters (the JAX ResPool returns before its MLP).  Every other
readout concatenates the targets' rows with the pooled block (or, for
center, takes the targets' residue alone) and runs the trailing Dropout
-> Linear(dim) -> act -> ``norm_feat``.  Sort-k pooling ranks the
(residue of the) layers' rows by :func:`masked_sort_pool` and maps the
[B, k*F] result through ``nn_pool``, Dropout -> Linear(k*F -> F) -> act,
before the concat; one ``Act`` serves both linears, as the flax
module's ``Act_0`` does.  Blocks keep their dtype (a
bf16 block pools in bf16, the mean's count too, as the JAX pools do);
the linear takes ``precision`` (``nn/layers.py``).
:class:`EnsembleAggregator` combines the branches' embeddings of an
ensemble model.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from shadow_gnn_torch.nn.layers import Act, TorchLinear, dropout, gather_rows, norm_feat
from shadow_gnn_torch.ops.precision import matmul
from shadow_gnn_torch.ops.segment import (masked_max_pool, masked_mean_pool,
                                          masked_sort_pool, masked_sum_pool)

_POOL_FN = {"mean": masked_mean_pool, "max": masked_max_pool,
            "sum": masked_sum_pool}
RESIDUES = ("none", "sum", "max", "concat", "cat")


def f_residue(feats: Sequence[torch.Tensor], type_res: str) -> torch.Tensor:
    """JK-style combination of the layers' outputs (layers.py:120-130)."""
    if type_res in ("cat", "concat"):
        return torch.cat(list(feats), dim=-1)
    if type_res == "sum":
        return sum(feats[1:], feats[0])
    if type_res == "max":
        return torch.stack(list(feats), 0).amax(0)
    raise NotImplementedError(type_res)


def _gather_targets(feat: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """feat [B, N, F], targets [B, T] -> [B*T, F]."""
    return gather_rows(feat, targets).reshape(-1, feat.shape[-1])


class ResPool(nn.Module):
    def __init__(self, dim_hid: int, num_layers: int, type_res: str,
                 type_pool: str, dropout: float = 0.0, act: str = "relu",
                 prediction_task: str = "node", precision: str = "float32",
                 sort_k: int = 0):
        super().__init__()
        if prediction_task not in ("node", "link"):
            raise ValueError(f"unknown prediction task {prediction_task!r}")
        if type_pool not in ("center", "sort", *_POOL_FN) or type_res not in RESIDUES:
            raise ValueError(f"unknown readout {type_pool}/{type_res}")
        if type_pool == "sort" and sort_k < 1:
            raise ValueError("sort pooling needs k >= 1 (pooling: sort-<k>)")
        self.type_res, self.type_pool = type_res, type_pool
        self.dropout, self.sort_k = dropout, sort_k
        self.link = prediction_task == "link"
        self.has_mlp = not (type_pool == "center" and type_res == "none"
                            and not self.link)
        if self.has_mlp:
            width = dim_hid * (num_layers if type_res in ("cat", "concat") else 1)
            dim_in = width if type_pool == "center" else 2 * width
            self.act = Act(act, dim_hid)
            if type_pool == "sort":
                self.nn_pool = TorchLinear(sort_k * width, width, precision)
            self.lin = TorchLinear(dim_in, dim_hid, precision)
            self.scale = nn.Parameter(torch.ones(dim_hid))
            self.offset = nn.Parameter(torch.zeros(dim_hid))

    @property
    def reads_target_rows(self) -> bool:
        """Whether the readout reads nothing of the layers' blocks but the
        targets' rows (center pooling, any residue, either task)."""
        return self.type_pool == "center"

    def _aggr_target_emb(self, feat: torch.Tensor) -> torch.Tensor:
        """Link task: [B*2, F] target rows -> src (*) dst [B, F]."""
        if not self.link:
            return feat
        pair = feat.reshape(-1, 2, feat.shape[-1])
        return pair[:, 0] * pair[:, 1]

    def forward(self, feats_l: Sequence[torch.Tensor], targets: torch.Tensor,
                node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                last_at_targets: bool = False) -> torch.Tensor:
        """feats_l: per-conv-layer [B, N, F]; targets [B, T] (T = 2 for
        the link task); node_mask [B, N] -> [B, dim].
        ``last_at_targets``: the last layer's block is already its rows at
        the targets, [B, T, F] (where :attr:`reads_target_rows`)."""
        tp, tr = self.type_pool, self.type_res
        if last_at_targets and not self.reads_target_rows:
            raise ValueError(f"{tp} pooling reads every row of the last layer")
        if tr == "none":
            feats_l = feats_l[-1:]
        *before, last = feats_l
        roots = [_gather_targets(f, targets) for f in before]
        roots.append(last.reshape(-1, last.shape[-1]) if last_at_targets
                     else _gather_targets(last, targets))
        feat_in = roots[0] if tr == "none" else f_residue(roots, tr)
        if not self.has_mlp:
            return feat_in
        feat_in = self._aggr_target_emb(feat_in)
        if tp == "sort":
            block = feats_l[0] if tr == "none" else f_residue(feats_l, tr)
            h = masked_sort_pool(block, node_mask, self.sort_k)
            if self.training:
                h = dropout(h, self.dropout, generator)
            feat_in = torch.cat([feat_in, self.act(self.nn_pool(h))], dim=-1)
        elif tp != "center":
            pools = [_POOL_FN[tp](f, node_mask) for f in feats_l]
            pool = pools[0] if tr == "none" else f_residue(pools, tr)
            feat_in = torch.cat([feat_in, pool], dim=-1)
        h = dropout(feat_in, self.dropout, generator) if self.training else feat_in
        return norm_feat(self.act(self.lin(h)), self.scale, self.offset)


class EnsembleAggregator(nn.Module):
    """Softmax attention over the ensemble branches (reference
    layers.py:236-296, the JAX package's ``nn/respool.py``): each
    branch's embedding x_i scores ``act(lin(x_i)) @ q`` (``q`` starts at
    ones), and the output is the softmax-weighted sum of the x_i.
    ``type_dropout``: ``none``; ``feat`` drops out each x_i before it is
    scored and summed; ``coef`` drops out only the copy that is scored.
    Dropout masks come from the caller's generator, in training mode.
    ``dim_in``: the embeddings' width (default ``dim_hid``; the
    post-ensemble scores stored embeddings of another width)."""

    def __init__(self, dim_hid: int, dropout: float = 0.0, act: str = "leakyrelu",
                 type_dropout: str = "none", precision: str = "float32",
                 dim_in: Optional[int] = None):
        super().__init__()
        if type_dropout not in ("none", "feat", "coef"):
            raise ValueError(f"unknown ensemble_dropout {type_dropout!r}")
        self.act = Act(act, dim_hid)
        self.lin = TorchLinear(dim_in or dim_hid, dim_hid, precision)
        self.q = nn.Parameter(torch.ones(dim_hid))
        self.dropout, self.type_dropout = dropout, type_dropout
        self.precision = precision

    def forward(self, xs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """xs: per-branch [B, dim] -> [B, dim]."""
        drop = self.training and self.type_dropout != "none"
        omegas, kept = [], []
        for x in xs:
            x_ = dropout(x, self.dropout, generator) if drop else x
            if self.type_dropout == "feat":
                x = x_
            kept.append(x)
            h = self.act(self.lin(x_))
            omegas.append(h @ self.q if self.precision == "float32"
                          else matmul(h, self.q[:, None], self.precision)[:, 0])
        w = torch.softmax(torch.stack(omegas, -1), dim=-1)
        return sum(w[:, i:i + 1] * x for i, x in enumerate(kept))
