"""DeepGNN: the shaDow-GNN model (one ensemble branch).

Per branch: masked node features (label-input columns zeroed at the
targets in the TRAIN mode) + hop one-hot augment -> L x conv (SAGE or
GAT; node mask after every conv) -> ResPool -> L2 normalise -> MLP
classifier with ``norm_feat`` on the logits.  The adjacency is
normalised and edge-dropped once per batch and reused by every conv.
SAGE on cached batches with ``packed_adj`` aggregates from the packed
bits through ``ops/packed.packed_spmm``, whose backward is the
transposed kernel ``packed_spmm_t``; otherwise it multiplies the dense
rw-normalised block.  GAT takes the dense pair (edge-dropped block,
structural block) into ``ops/gat.gat_attention``.  Every path draws the
same counter-hash dropedge mask (``ops/normalize.py``) from one seed
per forward.

Training follows the module's mode: in ``train()`` mode each conv
drops out its input (``dropout``), so does ResPool, and the aggregation
drops edges (``dropedge``); in ``eval()`` mode neither.  Zeroing the
label inputs follows the data mode instead (``mode_train``): it is on
in TRAIN steps and in evaluation passes over the TRAIN node set, off in
VALID/TEST passes and in serving.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
from torch import nn

from shadow_gnn_torch.nn.layers import GATConv, MLPLayer, SAGEConv, TorchLinear
from shadow_gnn_torch.nn.respool import ResPool
from shadow_gnn_torch.ops.normalize import prepare_adj
from shadow_gnn_torch.ops.packed import packed_spmm
from shadow_gnn_torch.sampling.batch import AUG2DIM, SubgraphBatch, batch_aug_onehots


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model configuration: the JAX package's fields that the
    ported model reads (its ensemble fields come with that path)."""

    dim_feat_smooth: int
    dim_label_raw: int          # num classes
    dim_label_smooth: int       # label-as-feature input dim (0 = unused)
    aggr: str = "sage"
    num_layers: int = 3
    dim: int = 256
    act: str = "relu"
    layer_norm: str = "norm_feat"
    heads: int = 1                # the parsed config's default is -1
    residue: str = "none"
    pooling: str = "center"
    loss: str = "softmax"
    num_cls_layers: int = 1
    feature_augment: Tuple[str, ...] = ()
    feature_augment_ops: str = "sum"
    num_ensemble: int = 1
    prediction_task: str = "node"
    dropout: float = 0.0
    dropedge: float = 0.0
    # aggregate cached batches from the packed bits (ops/packed.py);
    # gcn / sage / gin only, as in the JAX package
    packed_adj: bool = False

    @property
    def type_pool(self) -> str:
        return self.pooling.split("-")[0]

    @property
    def sigmoid_loss(self) -> bool:
        return self.loss == "sigmoid"

    @property
    def dim_feat_in(self) -> int:
        return self.dim_feat_smooth

    @property
    def mulhead(self) -> int:
        return max(1, self.heads)

    @property
    def reads_packed_bits(self) -> bool:
        """Whether cached batches aggregate from the packed bits (then no
        dense block is unpacked for them)."""
        return self.packed_adj and self.aggr in ("gcn", "sage", "gin")


class DeepGNN(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        unported = []
        if cfg.num_ensemble != 1:
            unported.append(f"{cfg.num_ensemble}-branch ensembles")
        if cfg.aggr not in ("sage", "gat"):
            unported.append(f"aggr {cfg.aggr!r}")
        if cfg.layer_norm != "norm_feat":
            unported.append(f"layer norm {cfg.layer_norm!r}")
        if cfg.feature_augment_ops != "sum" and cfg.feature_augment:
            unported.append(f"feature_augment_ops {cfg.feature_augment_ops!r}")
        if unported:
            raise NotImplementedError("not ported yet: " + ", ".join(unported))
        self.cfg = cfg
        self.aug = nn.ModuleDict({a: TorchLinear(AUG2DIM[a], cfg.dim_feat_in)
                                  for a in sorted(cfg.feature_augment)})
        dims = ([cfg.dim_feat_in + cfg.dim_label_smooth]
                + [cfg.dim] * cfg.num_layers)
        if cfg.aggr == "gat":
            convs = [GATConv(dims[i], dims[i + 1], cfg.mulhead, act=cfg.act,
                             dropout=cfg.dropout) for i in range(cfg.num_layers)]
        else:
            convs = [SAGEConv(dims[i], dims[i + 1], act=cfg.act,
                              dropout=cfg.dropout) for i in range(cfg.num_layers)]
        self.convs = nn.ModuleList(convs)
        self.res_pool = ResPool(cfg.dim, cfg.num_layers, cfg.residue,
                                cfg.type_pool, cfg.dropout, cfg.act,
                                cfg.prediction_task)
        cls = []
        for i in range(cfg.num_cls_layers):
            last = i == cfg.num_cls_layers - 1
            cls.append(MLPLayer(cfg.dim, cfg.dim_label_raw if last else cfg.dim,
                                act="I" if last else cfg.act,
                                dropout=0.0 if last else cfg.dropout))
        self.classifier = nn.ModuleList(cls)

    def aggregator(self, batch: SubgraphBatch, seed: int = 0):
        """What each conv aggregates through for this batch, prepared once
        for all convs (edges dropped in training mode under ``seed``):
        SAGE a callable x -> A_norm @ x, GAT the pair (adj_norm,
        adj_struct)."""
        de = self.cfg.dropedge if self.training else 0.0
        if self.cfg.reads_packed_bits and batch.adj_bits is not None:
            return functools.partial(packed_spmm, batch.adj_bits, norm="rw",
                                     dropedge=de, seed=seed)
        if batch.adj is None:
            raise ValueError("batch carries no dense adjacency and the model "
                             "does not read packed bits")
        adjs = prepare_adj(self.cfg.aggr, batch.adj, seed, de)
        if self.cfg.aggr == "gat":
            return adjs
        return functools.partial(torch.bmm, adjs[0])

    def forward(self, batch: SubgraphBatch, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dropedge_seed: int = 0, mode_train: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """feat: the gathered [B, N, F] node-feature block (features, then
        ``dim_label_smooth`` label-input columns).  In training mode,
        ``generator`` (on feat's device) draws the dropout masks and
        ``dropedge_seed`` (an int in [0, 2**31 - 1), drawn on the host)
        picks the dropedge mask.  ``mode_train`` zeroes the label inputs
        at the targets (models.py:182-183).  Returns (logits [B, C],
        [emb [B, dim]])."""
        mask = batch.node_mask[..., None].to(feat.dtype)
        x = feat * mask
        d_lab = self.cfg.dim_label_smooth
        if d_lab > 0 and mode_train:
            keep = 1.0 - torch.nn.functional.one_hot(
                batch.targets, x.shape[1]).sum(1).to(x.dtype)      # [B, N]
            label_cols = torch.arange(x.shape[-1], device=x.device) >= (
                x.shape[-1] - d_lab)
            x = torch.where(label_cols, x * keep[..., None], x)
        if self.aug:
            augs = batch_aug_onehots(batch, self.aug.keys())
            for a, lin in self.aug.items():
                emb_a = lin(augs[a])                # the feature columns only
                if d_lab > 0:
                    emb_a = torch.nn.functional.pad(emb_a, (0, d_lab))
                x = x + emb_a
        agg = self.aggregator(batch, dropedge_seed)
        xjk = []
        for conv in self.convs:
            x = conv(x, agg, generator) * mask
            xjk.append(x)
        emb = self.res_pool(xjk, batch.targets, batch.node_mask,
                            generator).float()
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True),
                                min=1e-12)
        h = emb
        for layer in self.classifier:
            h = layer(h, generator)
        return h.float(), [emb]


def row_losses(cfg: ModelConfig, logits: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Per-row loss [B]: BCE-with-logits summed over the C classes
    (C x their mean), or CE over (argmax) labels."""
    if cfg.sigmoid_loss:
        lab = labels.to(logits.dtype)
        bce = (torch.clamp(logits, min=0) - logits * lab
               + torch.log1p(torch.exp(-logits.abs())))
        return bce.mean(-1) * logits.shape[-1]
    if labels.dim() == 2:
        labels = labels.argmax(-1)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


def loss_fn(cfg: ModelConfig, logits: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Reference models.py:156-166: the batch mean of :func:`row_losses`."""
    return row_losses(cfg, logits, labels).mean()


def predict_fn(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.sigmoid_loss:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)
