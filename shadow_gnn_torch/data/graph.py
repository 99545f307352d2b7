"""Core graph containers.

``RawGraph`` is the host-side CSR graph with features, labels and
splits (numpy).  ``DeviceGraph`` holds the CSR of one split as torch
tensors on a device, where the sampler and the row induction read it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from shadow_gnn_torch import TRAIN


@dataclass
class RawGraph:
    """Host-side full graph in CSR form plus features / labels / splits.

    ``adj_*`` are (indptr, indices) pairs; edge values are implicitly 1.
    """

    indptr_full: np.ndarray
    indices_full: np.ndarray
    indptr_train: Optional[np.ndarray]
    indices_train: Optional[np.ndarray]
    feat_full: Optional[np.ndarray]
    label_full: Optional[np.ndarray]
    node_set: Optional[Dict[int, np.ndarray]]       # {TRAIN/VALID/TEST: node idx}
    edge_set: Optional[Dict[int, Dict[str, np.ndarray]]]  # link task: {'pos','neg'}

    def __post_init__(self):
        if self.feat_full is not None and self.feat_full.shape[0] != self.num_nodes:
            raise ValueError("feat_full rows != num_nodes")
        if self.label_full is not None and self.label_full.shape[0] != self.num_nodes:
            raise ValueError("label_full rows != num_nodes")

    @property
    def num_nodes(self) -> int:
        return self.indptr_full.size - 1

    @property
    def is_transductive(self) -> bool:
        return (self.indices_train is None
                or self.indices_train.size == self.indices_full.size)

    @property
    def prediction_task(self) -> str:
        return "node" if self.node_set is not None else "link"

    def adj(self, mode: int):
        """(indptr, indices) used for sampling in the given mode: TRAIN
        uses adj_train when inductive, VALID/TEST use adj_full."""
        if mode == TRAIN and self.indptr_train is not None:
            return self.indptr_train, self.indices_train
        return self.indptr_full, self.indices_full


def plan_row_block(num_edges: int) -> int:
    """The JAX package's neighbour-block width for a graph of
    ``num_edges`` edges (``DeviceGraph.from_csr`` there: 128 from 2**28
    edges on, else 32).  The port gathers no blocks; its induction plan
    prices the JAX gather at this width, so that both choose one
    ``deg_cap``."""
    return 128 if num_edges >= 2**28 else 32


@dataclass
class DeviceGraph:
    """CSR of (a split of) the graph as int64 tensors on ``device``.

    ``indices`` is the CSR column array without padding; row ``v``'s
    neighbours are ``indices[indptr[v]:indptr[v+1]]``, sorted ascending.
    ``max_deg`` is the largest row's length.
    """

    indptr: torch.Tensor     # [N+1] int64
    indices: torch.Tensor    # [E] int64
    num_nodes: int
    num_edges: int
    max_deg: int = 0

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: np.ndarray,
                 device="cpu") -> "DeviceGraph":
        n = indptr.size - 1
        return cls(
            indptr=torch.as_tensor(np.asarray(indptr, np.int64), device=device),
            indices=torch.as_tensor(np.asarray(indices, np.int64), device=device),
            num_nodes=n,
            num_edges=int(indices.size),
            max_deg=int(np.diff(indptr).max()) if n > 0 else 0,
        )

    @property
    def row_block(self) -> int:
        return plan_row_block(self.num_edges)

    @property
    def search_steps(self) -> int:
        """Binary-search steps that cover any CSR row."""
        return max(1, int(np.ceil(np.log2(max(2, self.max_deg + 1)))) + 1)


def is_undirected(indptr: np.ndarray, indices: np.ndarray,
                  max_exact_edges: int = 20_000_000, sample: int = 20_000,
                  seed: int = 0) -> bool:
    """True iff every edge (u, v) has a reverse (v, u).

    Exact (scipy transpose compare) up to ``max_exact_edges``; beyond
    that a reverse-membership check over ``sample`` random edges.
    """
    m = int(indices.size)
    if m == 0:
        return True
    if m <= max_exact_edges:
        import scipy.sparse as sp
        n = indptr.size - 1
        a = sp.csr_matrix((np.ones(m, np.int8), indices, indptr),
                          shape=(n, n))
        return (a != a.T).nnz == 0
    rng = np.random.default_rng(seed)
    eids = np.sort(rng.choice(m, size=min(sample, m), replace=False))
    src = np.searchsorted(indptr, eids, side="right") - 1
    dst = indices[eids]
    for s, d in zip(src, dst):
        sl = indices[indptr[d]:indptr[d + 1]]
        p = np.searchsorted(sl, s)
        if p >= sl.size or sl[p] != s:
            return False
    return True
