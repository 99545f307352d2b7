"""Synthetic graph generators (numpy).

The same seed gives the same arrays as the JAX package's
``data/synthetic.py``, so a test or a benchmark can hand one graph to
both packages.
"""
from __future__ import annotations

import numpy as np

from shadow_gnn_torch import TRAIN, VALID, TEST
from shadow_gnn_torch.data.graph import RawGraph


def make_random_graph(num_nodes: int, avg_deg: float, seed: int = 0,
                      power_law: bool = False):
    """Random undirected graph as CSR (indptr, indices), no self loops."""
    rng = np.random.default_rng(seed)
    num_edges_dir = int(num_nodes * avg_deg / 2)
    if power_law:
        # preferential-attachment-ish: endpoints ~ zipf-weighted
        w = 1.0 / (np.arange(1, num_nodes + 1) ** 0.75)
        w /= w.sum()
        src = rng.choice(num_nodes, size=num_edges_dir, p=w)
        dst = rng.choice(num_nodes, size=num_edges_dir, p=w)
    else:
        src = rng.integers(0, num_nodes, size=num_edges_dir)
        dst = rng.integers(0, num_nodes, size=num_edges_dir)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    row = np.concatenate([src, dst])
    col = np.concatenate([dst, src])
    key = np.unique(row.astype(np.int64) * num_nodes + col.astype(np.int64))
    row_u = (key // num_nodes).astype(np.int32)
    col_u = (key % num_nodes).astype(np.int32)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, row_u + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return indptr, col_u


def make_synthetic_dataset(
    num_nodes: int = 2000,
    avg_deg: float = 8.0,
    num_feat: int = 32,
    num_classes: int = 7,
    seed: int = 0,
    multilabel: bool = False,
    task: str = "node",
    power_law: bool = False,
) -> RawGraph:
    """Random graph + community-correlated features/labels (node task).

    Labels are planted from a random community assignment, then smoothed
    one step over the graph so that aggregation beats an MLP.
    """
    if task != "node":
        raise NotImplementedError(
            "the PyTorch port has no link task yet: synthetic link "
            "datasets come with the link-task slice")
    rng = np.random.default_rng(seed + 1)
    indptr, indices = make_random_graph(num_nodes, avg_deg, seed, power_law)
    comm = rng.integers(0, num_classes, size=num_nodes)
    centers = rng.normal(size=(num_classes, num_feat)).astype(np.float32)
    feat = centers[comm] + 0.8 * rng.normal(size=(num_nodes, num_feat)).astype(np.float32)
    deg = np.maximum(np.diff(indptr), 1)
    onehot = np.zeros((num_nodes, num_classes), dtype=np.float32)
    onehot[np.arange(num_nodes), comm] = 1.0
    agg = np.zeros_like(onehot)
    src = np.repeat(np.arange(num_nodes), np.diff(indptr))
    np.add.at(agg, src, onehot[indices])
    label_soft = onehot + agg / deg[:, None]
    if multilabel:
        label = (label_soft > 0.6).astype(np.float32)
        label[np.arange(num_nodes), comm] = 1.0
    else:
        label = label_soft.argmax(1).astype(np.int64)

    perm = rng.permutation(num_nodes)
    n_tr, n_va = int(0.6 * num_nodes), int(0.2 * num_nodes)
    node_set = {
        TRAIN: np.sort(perm[:n_tr]).astype(np.int64),
        VALID: np.sort(perm[n_tr:n_tr + n_va]).astype(np.int64),
        TEST: np.sort(perm[n_tr + n_va:]).astype(np.int64),
    }
    return RawGraph(
        indptr_full=indptr,
        indices_full=indices,
        indptr_train=None,
        indices_train=None,
        feat_full=feat,
        label_full=label,
        node_set=node_set,
        edge_set=None,
    )
