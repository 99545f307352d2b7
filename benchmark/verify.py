"""The reference's side of a run: the inputs of a cell and seed made
anew (``gen``), and from them the graph of each mode, its PPR top-k
tables and subgraphs (``reference/``).  Each entry module
(``entries/<entry>.py``) judges the program's readings with it: what it
compares, and the control (the reference in the program's place, its
products in TF32 where the configuration states f32), are the entry's.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from benchmark import gen
from benchmark.reference import ppr, subgraph

TRAIN, VALID, TEST = 0, 1, 2


@contextlib.contextmanager
def precision(tf32: bool):
    """f32 products (TF32 off), or TF32 ones for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rank_seed(seed: int, rank: int) -> int:
    """A rank's dropout / dropedge seed in an epoch of seed ``seed``."""
    return (seed ^ (rank * 0x9E3779B9)) & (2**63 - 1)


class Reference:
    """The reference's inputs of one cell and seed, made anew from the
    seed: the graph of each mode, the features, the weights."""

    def __init__(self, cell: Dict, seed: int, device):
        import importlib
        self.cell, self.cfg, self.seed, self.device = cell, cell["config"], seed, device
        self.model = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")
        self.data = gen.make_dataset(self.cfg["data"], seed, device)
        feat = self.data["feat"]
        self.label_steps = 0
        if hasattr(self.model, "label_inputs"):
            lab, self.label_steps = self.model.label_inputs(self.data, device)
            feat = np.concatenate([feat, lab], 1)
        self.feat = torch.as_tensor(feat, device=device)
        self.label = torch.as_tensor(self.data["label"], device=device)
        self.w0 = gen.make_weights(self.model.param_specs(self.cfg), seed, device)
        sampler = self.cfg["train_config"]["sampler"][-1]
        self.k = int(sampler["k"][0])
        self.alpha = float(sampler.get("alpha", [0.85])[0])
        self.n = self.cfg["data"]["num_nodes"]
        self.n_pad = -(-(self.k + 1) // 8) * 8
        self.self_edges = self.cfg["train_config"]["architecture"]["aggr"] in (
            "gcn", "gat", "gatscat")
        self._graphs = {}

    def graph(self, mode: int):
        """(CSR tensors, P^T) of the graph ``mode`` samples from."""
        inductive = self.data["indptr_train"] is not None and mode == TRAIN
        key = "train" if inductive else "full"
        if key not in self._graphs:
            ip, ix = ((self.data["indptr_train"], self.data["indices_train"]) if inductive
                      else (self.data["indptr"], self.data["indices"]))
            self._graphs[key] = (subgraph.device_graph(ip, ix, self.device),
                                 ppr.transition_t(ip, ix, self.device))
        return self._graphs[key]

    def subgraphs(self, mode: int, roots: np.ndarray) -> Dict[str, torch.Tensor]:
        g, p_t = self.graph(mode)
        neighs, _ = ppr.topk_tables(p_t, roots, self.k, self.alpha)
        r = torch.as_tensor(np.asarray(roots, np.int64), device=self.device)
        return subgraph.build(g, r, neighs, self.n, self.n_pad, self.self_edges)

    def stats(self, mode: int, roots: np.ndarray) -> Dict[str, float]:
        """Mean real nodes and edges a subgraph."""
        sub = self.subgraphs(mode, roots)
        return {"nodes": float(sub["real"].sum(1).float().mean()),
                "edges": float(sub["adj"].sum((1, 2)).mean())}
