"""Dataset loading: shaDow format directory -> RawGraph (numpy).

Undirected conversion with an on-disk cache, transductive/inductive
adjacency selection, and StandardScaler-equivalent feature
normalisation fit on the train nodes (inductive) or all nodes
(transductive).  Node-task splits only; the link task comes later.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from shadow_gnn_torch import TRAIN, VALID, TEST
from shadow_gnn_torch.data import format as fmt
from shadow_gnn_torch.data.graph import RawGraph


def standard_scale(feats: np.ndarray, fit_idx) -> np.ndarray:
    """sklearn StandardScaler semantics (population std, zero std -> 1)."""
    fit = feats[fit_idx] if fit_idx is not None else feats
    mean = fit.mean(axis=0)
    std = fit.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return ((feats - mean) / std).astype(np.float32)


def load_data(prefix: str, dataset: str, config_data: Dict[str, Any],
              printf=print) -> RawGraph:
    d = f"{prefix}/{dataset}"
    if not os.path.isfile(f"{d}/split.npy"):
        raise FileNotFoundError(
            f"{d}/split.npy missing: convert the dataset to shaDow format "
            "first (the PyTorch port does not download datasets)")
    role = np.load(f"{d}/split.npy", allow_pickle=True)
    if isinstance(role, np.ndarray):
        role = role[()]
    if isinstance(next(iter(role.values())), dict):
        raise NotImplementedError("link-task datasets are not ported yet")
    node_set = {m: np.asarray(role[m], dtype=np.int64) for m in (TRAIN, VALID, TEST)}
    label_full = np.load(f"{d}/label_full.npy")

    def load_und(split_: str):
        """undirected adjacency with a disk cache"""
        adj = fmt.load_adj(prefix, dataset, "undirected", split_)
        if adj is None:
            raw = fmt.load_adj(prefix, dataset, "raw", split_)
            if raw is None:
                raise FileNotFoundError(f"missing adjacency for split {split_}")
            adj = fmt.to_undirected_csr(*raw)
            np.save(f"{d}/adj_{split_}_undirected.npy",
                    {"indptr": adj[0], "indices": adj[1]}, allow_pickle=True)
        return adj

    has_train = (os.path.isfile(f"{d}/adj_train_raw.npy")
                 or os.path.isfile(f"{d}/adj_train_raw.npz"))
    if config_data.get("to_undirected", False):
        indptr_full, indices_full = load_und("full")
        if config_data.get("transductive", False) or not has_train:
            indptr_train = indices_train = None
        else:
            indptr_train, indices_train = load_und("train")
    else:
        indptr_full, indices_full = fmt.load_adj(prefix, dataset, "raw", "full")
        if config_data.get("transductive", False):
            indptr_train = indices_train = None
        else:
            tr = fmt.load_adj(prefix, dataset, "raw", "train")
            indptr_train, indices_train = tr if tr is not None else (None, None)

    printf(f"SETTING TO {'TRANS' if indptr_train is None else 'IN'}DUCTIVE LEARNING")

    feats = np.load(f"{d}/feat_full.npy").astype(np.float32)
    if config_data.get("norm_feat", True):
        mode_norm = "all" if indptr_train is None else "train"
        cache = f"{d}/feat_full_norm_{mode_norm}.npy"
        if os.path.isfile(cache):
            feats = np.load(cache).astype(np.float32)
            printf(f"Loading '{mode_norm}'-normalized features")
        else:
            fit_idx = None if indptr_train is None else node_set[TRAIN]
            feats = standard_scale(feats, fit_idx)
            printf(f"Normalizing node features (mode = {mode_norm})")
    return RawGraph(
        indptr_full=indptr_full,
        indices_full=indices_full,
        indptr_train=indptr_train,
        indices_train=indices_train,
        feat_full=feats,
        label_full=label_full,
        node_set=node_set,
        edge_set=None,
    )
