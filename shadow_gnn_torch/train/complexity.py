"""Inference cost accounting (``--compute_complexity_only``).

The port of the JAX package's ``train/complexity.py`` (reference
main.py:299-331 and the layers' ``complexity()`` methods): sample real
evaluation batches, count each layer's operations from the sampled
subgraphs' node and edge counts, and report the mean inference cost per
root.  Edges are counted from the dense block, or from the packed bits
of a cached batch.  A link task's root is an edge (one subgraph of its
two targets).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from shadow_gnn_torch import MODE2STR, VALID
from shadow_gnn_torch.nn.model import ModelConfig
from shadow_gnn_torch.sampling.batch import AUG2DIM, SubgraphBatch
from shadow_gnn_torch.sampling.cache import unpack_bits


def _conv_ops(cfg: ModelConfig, n: float, e: float, f_in: int) -> float:
    """Operations of one conv layer on subgraphs of n nodes and e edges."""
    f = cfg.dim
    if cfg.aggr == "gcn":                      # layers.py:438-444
        return e * f_in + n * f_in * f
    if cfg.aggr == "sage":                     # layers.py:486-494
        return n * f_in * f * 2 + e * f_in
    if cfg.aggr in ("gat", "gatscat"):         # layers.py:628-645
        ops = 2 * n * f_in * f + 2 * n * f
        ops += cfg.mulhead * (2 * e + 20 * e)
        ops += e * f
        return ops
    if cfg.aggr == "gin":
        return e * f_in + n * f_in + n * f_in * f + n * f * f
    return n * f_in * f                        # mlp / sgc / sign


def _respool_ops(cfg: ModelConfig, n_roots: float, n_nodes: float) -> float:
    f = cfg.dim
    l = cfg.num_layers
    ops = 0.0
    if cfg.type_pool in ("mean", "max", "sum"):
        mult = 1 if cfg.residue == "none" else l
        ops += n_nodes * f * mult
        dim_in = 2 * f * (l if cfg.residue in ("cat", "concat") else 1)
        ops += n_roots * dim_in * f
    elif cfg.type_pool == "sort":
        dim = f * (l if cfg.residue in ("cat", "concat") else 1)
        ops += n_roots * cfg.sort_k * dim * dim        # nn_pool linear
        ops += n_roots * 2 * dim * f
    elif cfg.residue != "none":                # center + JK
        dim_in = f * (l if cfg.residue in ("cat", "concat") else 1)
        ops += n_roots * dim_in * f
    return ops


def batch_complexity(cfg: ModelConfig, sizes: np.ndarray, edges: np.ndarray,
                     feat_dim: int) -> float:
    """Inference operations of one batch of subgraphs, times the
    ensemble's branch count."""
    n = float(sizes.sum())
    e = float(edges.sum())
    b = float(sizes.shape[0])
    ops = 0.0
    if cfg.feature_augment:
        dim_out = cfg.dim_feat_in if cfg.feature_augment_ops == "sum" else cfg.dim
        for a in cfg.feature_augment:
            ops += n * AUG2DIM[a] * dim_out
    f_in = feat_dim
    for _ in range(cfg.num_layers):
        ops += _conv_ops(cfg, n, e, f_in)
        f_in = cfg.dim
    ops += _respool_ops(cfg, b, n)
    ops += b * cfg.dim * cfg.dim_label_raw       # classifier
    return ops * cfg.num_ensemble


def batch_edges(batch: SubgraphBatch) -> np.ndarray:
    """Stored entries of each subgraph's block [B]."""
    if batch.adj is not None:
        return batch.adj.sum((1, 2)).cpu().numpy()
    return unpack_bits(batch.adj_bits, batch.nodes.shape[1]).sum((1, 2)).cpu().numpy()


def compute_complexity(trainer, num_roots_budget: int = 0, modes=(VALID,),
                       unit: str = "G") -> Dict[int, float]:
    """Mean inference cost per root of each mode, over its evaluation
    batches until ``num_roots_budget`` roots (0: the whole mode) are
    counted; the khop picks from a generator seeded with ``SERVE_SEED``."""
    from shadow_gnn_torch.train.pipeline import SERVE_SEED
    norm = {"G": 1e9, "M": 1e6}[unit]
    out = {}
    for md in modes:
        trainer._ensure_tables(md)
        nb, roots, rows, _labels, w = trainer._epoch_arrays(md)
        budget = num_roots_budget or int(w.sum())
        feat_dim = trainer.dim_feat_smooth + trainer.dim_label_smooth
        gen = torch.Generator(device=trainer.device).manual_seed(SERVE_SEED)
        total_ops, total_roots = 0.0, 0
        if budget > 0:
            for sl, batches, _ in trainer._batches(md, nb, roots, rows, gen):
                for b in batches:
                    total_ops += batch_complexity(trainer.model_cfg,
                                                  b.size.cpu().numpy(),
                                                  batch_edges(b), feat_dim)
                total_roots += int(w[sl].sum())
                if total_roots >= budget:
                    break
        out[md] = total_ops / max(total_roots, 1)
        print(f"Average inference cost per node: "
              f"[{MODE2STR[md]:^8s}]    {out[md] / norm:.3f}{unit}")
    return out
