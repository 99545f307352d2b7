"""DeepGNN: the shaDow-GNN model, one or more ensemble branches.

Per branch: masked node features (label-input columns zeroed at the
targets in the TRAIN mode) + the one-hot augments (hop, PPR, DRNL: each
one's linear added to the feature columns, or with
``feature_augment_ops: concat`` appended) -> L x conv (the backbone's:
SAGE, GCN, GIN, GAT, GATScatter, or the MLP layer of ``mlp``/``sgc``/
``sign``, each with the ``layer_norm`` choice; node mask after every conv)
-> ResPool -> L2 normalise.  An ensemble combines the branches'
embeddings with ``EnsembleAggregator`` (softmax attention over the
branches); then the MLP classifier with ``norm_feat`` on the logits
(no norm on the link task's, whose subgraphs each hold an edge's two
targets and give one logit).  Each branch has its own augment linears,
convs and ResPool, named ``aug``, ``convs``, ``res_pool`` for branch 0
and with the suffix ``_<i>`` for branch i (``branch_sharing``: every
branch runs branch 0's convs), as the JAX package's ``aug_<i>_*``,
``conv_<i>_*``, ``res_pool_<i>``.  The adjacency is normalised and
edge-dropped once per batch and branch and reused by every conv of the
branch; branch i draws its dropedge mask from the forward's seed mixed
with i (:func:`branch_seed`).
SAGE, GCN and GIN on cached batches with ``packed_adj`` aggregate from
the packed bits through ``ops/packed.packed_spmm`` in the norm of the
backbone (``PACKED_NORM``: rw, sym, gin), whose backward is the
transposed kernel ``packed_spmm_t``; otherwise they multiply the dense
block that ``prepare_adj`` normalises.  GAT and GATScatter take the
dense pair (edge-dropped block, structural block) into
``ops/gat.gat_attention``.  The adjacency-free backbones prepare no
block.  Every path draws the
same counter-hash dropedge mask (``ops/normalize.py``) from one seed
per forward.
Where the readout reads nothing of the last conv's output but the
targets' rows (``ResPool.reads_target_rows``: center pooling) and that
conv is SAGE with a row-wise norm, the branch runs its linears, norms
and activations at the targets' rows alone (``SAGEConv``'s ``rows``;
the dropout and the aggregation still cover every row); ``last_conv_rows``
counts the branch forwards that did and did not.

Precision (``ModelConfig.matmul_precision`` / ``compute_dtype``, the
JAX package's ``--matmul_precision`` / ``--compute_dtype``):
``matmul_precision="bfloat16"`` runs every f32 product at bf16 precision
and ``"tensorfloat32"`` on TF32 tensor cores on a card (``ops/precision.py``);
both run the packed aggregation in its bf16 mode and GAT's attention at
its bf16 levels.  ``compute_dtype="bfloat16"`` casts the
feature block to bf16 (parameters stay f32 and are cast at use) and the
dense adjacency too, and takes the dense path (no packed bits); type
promotion then decides each later dtype, as in JAX: the label-input
select and the hop-augment add return the block to f32, a bf16 block
times an f32 parameter is f32.  The embedding's L2 normalisation and
the logits are f32.

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
import types
from typing import List, Optional, Tuple

import torch
from torch import nn

from shadow_gnn_torch.nn.layers import (ATTENTION, NAME2LAYER, NORMS, MLPLayer, SAGEConv,
                                        TorchLinear, gather_rows)
from shadow_gnn_torch.nn.respool import EnsembleAggregator, ResPool
from shadow_gnn_torch.ops.normalize import ADJ_FREE, prepare_adj
from shadow_gnn_torch.ops.packed import packed_spmm
from shadow_gnn_torch.ops.precision import PRECISIONS, ROUNDED_PRECISIONS, matmul
from shadow_gnn_torch.sampling.batch import (AUG2DIM, SubgraphBatch, batch_aug_onehots,
                                             one_hot)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model configuration: the JAX package's fields that the
    ported model reads."""

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
    branch_sharing: bool = False
    ensemble_act: str = "leakyrelu"
    ensemble_dropout: str = "none"     # none | feat | coef
    prediction_task: str = "node"
    dropout: float = 0.0
    dropedge: float = 0.0
    # aggregate cached batches from the packed bits (ops/packed.py);
    # the PACKED_NORM backbones only, as in the JAX package
    packed_adj: bool = False
    # products: "float32", "bfloat16" (bf16 operands, f32 sums) or
    # "tensorfloat32" (TF32 tensor cores on a card)
    matmul_precision: str = "float32"
    # activation dtype: "float32" or "bfloat16" (params / logits stay f32)
    compute_dtype: str = "float32"

    @property
    def type_pool(self) -> str:
        return self.pooling.split("-")[0]

    @property
    def sort_k(self) -> int:
        """k of ``pooling: sort-<k>`` (0 otherwise)."""
        parts = self.pooling.split("-")
        return int(parts[1]) if len(parts) > 1 else 0

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
    def dtype(self) -> torch.dtype:
        """The activation dtype."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def uses_adj(self) -> bool:
        """Whether the convs read the adjacency (``mlp``/``sgc``/``sign``
        do not)."""
        return self.aggr not in ADJ_FREE

    @property
    def reads_packed_bits(self) -> bool:
        """Whether cached batches aggregate from the packed bits: a bf16
        compute dtype takes the dense path (shadow_gnn_tpu/nn/model.py:139)."""
        return (self.packed_adj and self.aggr in PACKED_NORM
                and self.compute_dtype == "float32")

    @property
    def needs_dense_adj(self) -> bool:
        """Whether a cached batch must carry its dense block (unpacked
        from the bits): not when the model reads the bits or no block."""
        return self.uses_adj and not self.reads_packed_bits


# the packed kernel's norm of each backbone that aggregates through it
# (shadow_gnn_tpu/nn/model.py:142)
PACKED_NORM = {"gcn": "sym", "sage": "rw", "gin": "gin"}


# branch forwards whose last conv ran at the targets' rows alone
# (``target_rows``) or at every row (``full_rows``); a graph replay is
# credited its capture's counts (train/graphs.py:launch_counters)
last_conv_rows = types.SimpleNamespace(__name__="last_conv_rows", target_rows=0,
                                       full_rows=0)


def branch_seed(seed, i: int):
    """Branch i's dropedge seed from the forward's ``seed`` (branch 0
    uses ``seed`` itself), in [0, 2**31 - 1): an int, or for an int64
    tensor seed (a CUDA graph's static seed buffer) a new tensor of the
    same value, computed on the device."""
    return (seed + i * 0x9E3779B1) % (2**31 - 1)


def branch_suffix(i: int) -> str:
    """The suffix of branch i's module names: none for branch 0."""
    return f"_{i}" if i else ""


class DeepGNN(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.aggr not in NAME2LAYER:
            raise ValueError(f"unknown aggr {cfg.aggr!r}")
        if cfg.layer_norm not in NORMS:
            raise ValueError(f"unknown layer_norm {cfg.layer_norm!r}")
        if cfg.matmul_precision not in PRECISIONS:
            raise ValueError(f"unknown matmul_precision {cfg.matmul_precision!r}")
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
        if cfg.feature_augment_ops not in ("sum", "concat"):
            raise ValueError(f"unknown feature_augment_ops {cfg.feature_augment_ops!r}")
        if cfg.num_ensemble < 1:
            raise ValueError(f"num_ensemble {cfg.num_ensemble} < 1")
        self.cfg = cfg
        prec = cfg.matmul_precision
        # "sum" adds each augment's linear (to dim_feat_in) to the
        # feature columns; "concat" appends each one's (to dim)
        concat = cfg.feature_augment_ops == "concat"
        dim_aug = cfg.dim if concat else cfg.dim_feat_in
        dims = ([cfg.dim_feat_in + cfg.dim_label_smooth
                 + (dim_aug * len(cfg.feature_augment) if concat else 0)]
                + [cfg.dim] * cfg.num_layers)
        for i in range(cfg.num_ensemble):
            sfx = branch_suffix(i)
            self.add_module("aug" + sfx, nn.ModuleDict(
                {a: TorchLinear(AUG2DIM[a], dim_aug, prec)
                 for a in sorted(cfg.feature_augment)}))
            if i == 0 or not cfg.branch_sharing:
                layer = NAME2LAYER[cfg.aggr]
                kw = dict(act=cfg.act, dropout=cfg.dropout, precision=prec,
                          norm=cfg.layer_norm)
                if cfg.aggr in ATTENTION:
                    kw["heads"] = cfg.mulhead
                self.add_module("convs" + sfx, nn.ModuleList(
                    [layer(dims[l], dims[l + 1], **kw)
                     for l in range(cfg.num_layers)]))
            self.add_module("res_pool" + sfx, ResPool(
                cfg.dim, cfg.num_layers, cfg.residue, cfg.type_pool, cfg.dropout,
                cfg.act, cfg.prediction_task, prec, cfg.sort_k))
        if cfg.num_ensemble > 1:
            self.ensembler = EnsembleAggregator(cfg.dim, cfg.dropout,
                                                cfg.ensemble_act,
                                                cfg.ensemble_dropout, prec)
        cls = []
        for i in range(cfg.num_cls_layers):
            last = i == cfg.num_cls_layers - 1
            cls.append(MLPLayer(cfg.dim, cfg.dim_label_raw if last else cfg.dim,
                                act="I" if last else cfg.act,
                                dropout=0.0 if last else cfg.dropout,
                                precision=prec,
                                norm="norm_feat" if cfg.prediction_task == "node"
                                else "none"))
        self.classifier = nn.ModuleList(cls)

    def branch_modules(self, i: int):
        """(augment linears, convs, ResPool) of branch i."""
        sfx = branch_suffix(i)
        convs = "convs" if self.cfg.branch_sharing else "convs" + sfx
        return (getattr(self, "aug" + sfx), getattr(self, convs),
                getattr(self, "res_pool" + sfx))

    def aggregator(self, batch: SubgraphBatch, seed=0):
        """What each conv aggregates through for this batch, prepared once
        for all convs (edges dropped in training mode under ``seed``):
        SAGE, GCN and GIN a callable x -> A_norm @ x, GAT and GATScatter
        the pair (adj_norm, adj_struct), the adjacency-free backbones
        None."""
        cfg = self.cfg
        if not cfg.uses_adj:
            return None
        de = cfg.dropedge if self.training else 0.0
        if cfg.reads_packed_bits and batch.adj_bits is not None:
            return functools.partial(
                packed_spmm, batch.adj_bits, norm=PACKED_NORM[cfg.aggr], dropedge=de,
                seed=seed, bf16=cfg.matmul_precision in ROUNDED_PRECISIONS)
        if batch.adj is None:
            raise ValueError("batch carries no dense adjacency and the model "
                             "does not read packed bits")
        adjs = prepare_adj(cfg.aggr, batch.adj, seed, de)
        if cfg.aggr in ATTENTION:
            # 0/1 blocks: JAX's cast to the compute dtype and back to f32
            # for the kernel leaves them as they are
            return adjs
        return functools.partial(_dense_aggregate, adjs[0].to(cfg.dtype),
                                 cfg.matmul_precision)

    def forward(self, batches, feats, generator: Optional[torch.Generator] = None,
                dropedge_seed=0, mode_train: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """batches / feats: one SubgraphBatch and one gathered [B, N, F]
        node-feature block (features, then ``dim_label_smooth``
        label-input columns) per branch, or the batch and the block of a
        one-branch model.  In training mode, ``generator`` (on feat's
        device) draws the dropout masks and ``dropedge_seed`` (an int in
        [0, 2**31 - 1), drawn on the host, or an int64 tensor of one
        element on the device that holds it: the same masks) picks the
        dropedge masks.
        ``mode_train`` zeroes the label inputs at the targets
        (models.py:182-183).  Returns (logits [B, C], per-branch
        embeddings [B, dim])."""
        if isinstance(batches, SubgraphBatch):
            batches, feats = [batches], [feats]
        if len(batches) != self.cfg.num_ensemble:
            raise ValueError(f"{len(batches)} batches for "
                             f"{self.cfg.num_ensemble} branches")
        embs = [self._branch(i, batches[i], feats[i], generator,
                             branch_seed(dropedge_seed, i), mode_train)
                for i in range(len(batches))]
        h = embs[0] if len(embs) == 1 else self.ensembler(embs, generator)
        for layer in self.classifier:
            h = layer(h, generator)
        return h.float(), embs

    def _branch(self, i: int, batch: SubgraphBatch, feat: torch.Tensor,
                generator: Optional[torch.Generator], seed,
                mode_train: bool) -> torch.Tensor:
        """Branch i's L2-normalised [B, dim] f32 embedding."""
        aug, convs, res_pool = self.branch_modules(i)
        mask = batch.node_mask[..., None]
        x = (feat * mask.to(feat.dtype)).to(self.cfg.dtype)
        d_lab = self.cfg.dim_label_smooth
        if d_lab > 0 and mode_train:
            keep = 1.0 - one_hot(batch.targets, x.shape[1]).sum(1)  # [B, N]
            label_cols = torch.arange(x.shape[-1], device=x.device) >= (
                x.shape[-1] - d_lab)
            x = torch.where(label_cols, x * keep[..., None], x)
        elif d_lab > 0:
            # JAX selects in every mode, with an f32 ``keep``: a bf16
            # block comes out f32
            x = x.float()
        if aug:
            augs = batch_aug_onehots(batch, aug.keys())
            for a, lin in aug.items():
                emb_a = lin(augs[a])
                if self.cfg.feature_augment_ops == "concat":
                    x = torch.cat([x, emb_a], dim=-1)
                    continue
                if d_lab > 0:                       # the feature columns only
                    emb_a = torch.nn.functional.pad(emb_a, (0, d_lab))
                x = x + emb_a
        agg = self.aggregator(batch, seed)
        *body, tail = convs
        xjk = []
        for conv in body:
            x = conv(x, agg, generator, node_mask=batch.node_mask) * mask
            xjk.append(x)
        at_targets = (res_pool.reads_target_rows and isinstance(tail, SAGEConv)
                      and tail.norm != "pairnorm")
        if at_targets:
            x = tail(x, agg, generator, node_mask=batch.node_mask,
                     rows=batch.targets) * gather_rows(mask, batch.targets)
            last_conv_rows.target_rows += 1
        else:
            x = tail(x, agg, generator, node_mask=batch.node_mask) * mask
            last_conv_rows.full_rows += 1
        xjk.append(x)
        emb = res_pool(xjk, batch.targets, batch.node_mask, generator,
                       last_at_targets=at_targets).float()
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True),
                                 min=1e-12)


def _dense_aggregate(adj: torch.Tensor, precision: str, x: torch.Tensor) -> torch.Tensor:
    """adj @ x as JAX's einsum takes it (layers.py:419-420): both operands
    promoted to one dtype, an f32 product at ``precision``."""
    dt = torch.promote_types(adj.dtype, x.dtype)
    adj, x = adj.to(dt), x.to(dt)
    return matmul(adj, x, precision) if dt == torch.float32 else torch.bmm(adj, x)


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
