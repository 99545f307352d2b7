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
    """Random graph + community-correlated features/labels.

    Labels are planted from a random community assignment, then smoothed
    one step over the graph so that aggregation beats an MLP.  With
    ``task="link"`` the splits are edges instead (512 / 128 / 128
    positives, random VALID/TEST negatives) and the held-out positives
    leave the message graph, as ogbl-collab's ``adj_full`` holds only
    the training edges.
    """
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
    edge_set = None
    if task == "link":
        n_pos = {TRAIN: 512, VALID: 128, TEST: 128}
        all_src = np.repeat(np.arange(num_nodes), np.diff(indptr))
        upper = all_src < indices  # each undirected edge once
        pool = np.stack([all_src[upper], indices[upper]], 1)
        sel = rng.permutation(pool.shape[0])
        ofs = 0
        edge_set = {}
        for m in (TRAIN, VALID, TEST):
            pos = pool[sel[ofs:ofs + n_pos[m]]].astype(np.int64)
            ofs += n_pos[m]
            if m == TRAIN:
                edge_set[m] = {"pos": pos}
            else:
                neg = rng.integers(0, num_nodes, size=pos.shape).astype(np.int64)
                edge_set[m] = {"pos": pos, "neg": neg}
        node_set = None
        label = None
        held = np.concatenate([edge_set[VALID]["pos"], edge_set[TEST]["pos"]])
        key_held = np.concatenate([held[:, 0] * num_nodes + held[:, 1],
                                   held[:, 1] * num_nodes + held[:, 0]])
        key_all = all_src.astype(np.int64) * num_nodes + indices
        keep = ~np.isin(key_all, key_held)
        indices = indices[keep]
        indptr = np.concatenate([
            [0], np.cumsum(np.bincount(all_src[keep],
                                       minlength=num_nodes))]).astype(indptr.dtype)
    return RawGraph(
        indptr_full=indptr,
        indices_full=indices,
        indptr_train=None,
        indices_train=None,
        feat_full=feat,
        label_full=label,
        node_set=node_set,
        edge_set=edge_set,
    )


def make_planted_dataset(
    num_nodes: int = 20000,
    num_classes: int = 8,
    avg_deg: float = 15.0,
    p_in: float = 0.4,
    num_feat: int = 64,
    snr: float = 0.6,
    seed: int = 0,
    power_law: bool = False,
):
    """Planted-partition (SBM) node classification with weak features.

    The community is the label.  Features carry ``snr`` of community
    signal against unit noise, and an edge joins two members of one
    community with probability ``p_in``, so the label is recovered
    through aggregation over the neighbourhood.  Returns (RawGraph, the
    nearest-center accuracy of the features alone)."""
    rng = np.random.default_rng(seed + 17)
    comm = rng.integers(0, num_classes, size=num_nodes)
    order = np.argsort(comm, kind="stable")
    counts = np.bincount(comm, minlength=num_classes)
    offsets = np.concatenate([[0], np.cumsum(counts)])

    n_edges = int(num_nodes * avg_deg / 2)
    if power_law:
        wz = 1.0 / (np.arange(1, num_nodes + 1) ** 0.75)
        wz /= wz.sum()
        u = rng.choice(num_nodes, size=n_edges, p=wz)
    else:
        u = rng.integers(0, num_nodes, size=n_edges)
    same = rng.random(n_edges) < p_in
    # intra-community partner: a uniform member of comm[u]
    cu = comm[u]
    within = offsets[cu] + rng.integers(0, np.maximum(counts[cu], 1))
    v_same = order[np.minimum(within, num_nodes - 1)]
    v_rand = rng.integers(0, num_nodes, size=n_edges)
    v = np.where(same, v_same, v_rand)
    keep = u != v
    u, v = u[keep], v[keep]
    row = np.concatenate([u, v]).astype(np.int64)
    col = np.concatenate([v, u]).astype(np.int64)
    key = np.unique(row * num_nodes + col)
    row_u = (key // num_nodes).astype(np.int32)
    col_u = (key % num_nodes).astype(np.int32)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, row_u + 1, 1)
    indptr = np.cumsum(indptr).astype(
        np.int32 if key.size < 2**31 else np.int64)

    centers = rng.normal(size=(num_classes, num_feat)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    feat = (snr * centers[comm]
            + rng.normal(size=(num_nodes, num_feat)).astype(np.float32))
    # the features' own ceiling: the nearest-center rule (equal-norm
    # centers, so the largest dot product)
    feat_only_acc = float(((feat @ centers.T).argmax(1) == comm).mean())

    perm = rng.permutation(num_nodes)
    n_tr, n_va = int(0.6 * num_nodes), int(0.2 * num_nodes)
    node_set = {
        TRAIN: np.sort(perm[:n_tr]).astype(np.int64),
        VALID: np.sort(perm[n_tr:n_tr + n_va]).astype(np.int64),
        TEST: np.sort(perm[n_tr + n_va:]).astype(np.int64),
    }
    raw = RawGraph(
        indptr_full=indptr,
        indices_full=col_u,
        indptr_train=None,
        indices_train=None,
        feat_full=feat,
        label_full=comm.astype(np.int64),
        node_set=node_set,
        edge_set=None,
    )
    return raw, feat_only_acc
