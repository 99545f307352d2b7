"""shaDow on-disk format IO (numpy).

The canonical data-directory layout, the same one the JAX package reads
and writes:

    <prefix>/<name>/adj_full_raw.npz|npy      scipy-CSR or {indptr,indices[,data]}
    <prefix>/<name>/adj_train_raw.*           (inductive only)
    <prefix>/<name>/adj_*_undirected.npy      cached undirected conversion
    <prefix>/<name>/feat_full.npy             [N, F] float32
    <prefix>/<name>/label_full.npy            [N] int  or  [N, C] multilabel
    <prefix>/<name>/split.npy                 {0: train idx, 1: valid, 2: test}
    <prefix>/<name>/cpp/adj_<split>_<type>_<indptr|indices|data>.bin   raw CSR
    <prefix>/<name>/ppr_float/{neighs,scores}_*.bin                    PPR cache
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def to_undirected_csr(indptr: np.ndarray, indices: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetrize a CSR adjacency (union of out- and in-neighbours per
    row); dedup; discard edge values."""
    n = indptr.size - 1
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = indices.astype(np.int64)
    row = np.concatenate([src, dst])
    col = np.concatenate([dst, src])
    key = np.unique(row * n + col)
    row_u = (key // n).astype(np.int64)
    col_u = (key % n).astype(np.int64)
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(new_indptr, row_u + 1, 1)
    new_indptr = np.cumsum(new_indptr)
    dtype = np.int32 if max(n, col_u.size) < 2**31 else np.int64
    return new_indptr.astype(dtype), col_u.astype(dtype)


def _save_adj_npy(path: str, indptr: np.ndarray, indices: np.ndarray):
    np.save(path, {"indptr": indptr, "indices": indices}, allow_pickle=True)


def load_adj(prefix: str, dataset: str, type_: str, split_: str,
             suffix: str = "") -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Load an adjacency as (indptr, indices), or None if absent.  Reads
    both the .npz (scipy.save_npz) and the .npy (dict) encodings."""
    if split_ not in ("full", "train") or type_ not in ("raw", "undirected"):
        raise ValueError(f"bad adjacency kind {split_}/{type_}")
    base = f"{prefix}/{dataset}/adj_{split_}_{type_}{suffix}"
    if os.path.isfile(base + ".npz"):
        with np.load(base + ".npz") as z:
            return z["indptr"], z["indices"]
    if os.path.isfile(base + ".npy"):
        d = np.load(base + ".npy", allow_pickle=True)
        if isinstance(d, np.ndarray):
            d = d[()]
        return d["indptr"], d["indices"]
    return None


def write_bin_csr(dir_cpp: str, split_: str, type_: str,
                  indptr: np.ndarray, indices: np.ndarray):
    """Raw-binary CSR dump: flat little-endian uint32 arrays, no header;
    an empty data file means all ones."""
    if type_ not in ("undirected", "raw"):
        raise ValueError(type_)
    os.makedirs(dir_cpp, exist_ok=True)
    indptr.astype(np.uint32).tofile(
        f"{dir_cpp}/adj_{split_}_{type_}_indptr.bin")
    indices.astype(np.uint32).tofile(
        f"{dir_cpp}/adj_{split_}_{type_}_indices.bin")
    open(f"{dir_cpp}/adj_{split_}_{type_}_data.bin", "wb").close()


def save_shadow_format(prefix: str, name: str, *, indptr, indices, feat, label,
                       node_set=None, edge_set=None, indptr_train=None,
                       indices_train=None, write_bin: bool = True):
    """Write a dataset directory in shaDow format."""
    d = f"{prefix}/{name}"
    os.makedirs(d, exist_ok=True)
    _save_adj_npy(f"{d}/adj_full_raw.npy", indptr, indices)
    if indptr_train is not None:
        _save_adj_npy(f"{d}/adj_train_raw.npy", indptr_train, indices_train)
    np.save(f"{d}/feat_full.npy", np.asarray(feat, dtype=np.float32))
    if label is not None:
        np.save(f"{d}/label_full.npy", label)
    split = node_set if node_set is not None else edge_set
    np.save(f"{d}/split.npy", split, allow_pickle=True)
    if write_bin:
        write_bin_csr(f"{d}/cpp", "full", "raw", indptr, indices)
        if indptr_train is not None:
            write_bin_csr(f"{d}/cpp", "train", "raw", indptr_train, indices_train)
    return d
