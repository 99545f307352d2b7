"""Subgraph statistics of the first epoch (the reference's
SubgraphProfiler): per sampler branch, the hop composition of the
subgraphs' nodes and their average nodes, edges and degree.

The port's copy of ``shadow_gnn_tpu/train/profiler.py``.  The Trainer
feeds it one pass over its first TRAIN epoch (``Trainer._profile_epoch``,
whose step a CUDA graph replays on a card), prints the summary and
clears and disables it, as the reference does after its first epoch.
Batches are reduced on their device (:func:`batch_stats` reads nothing
on the host); only the totals come to the host.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from shadow_gnn_torch.sampling.batch import DIM_1HOT_HOP, SubgraphBatch, hop2onehot

# set bits of each byte value: edges of a packed block without unpacking it
_POPCOUNT = {torch.device("cpu"): torch.tensor([bin(i).count("1") for i in range(256)],
                                               dtype=torch.int64)}


def _popcount(device: torch.device) -> torch.Tensor:
    """The byte popcount table on ``device``, copied there once (on a
    step's eager warm-up, never inside a capture)."""
    if device not in _POPCOUNT:
        with torch.inference_mode(False):
            _POPCOUNT[device] = _POPCOUNT[torch.device("cpu")].to(device)
    return _POPCOUNT[device]


def batch_edges(batch: SubgraphBatch) -> torch.Tensor:
    """Edges of each subgraph [B] (int64), from the dense block or, when
    the batch carries only packed bits, from the bits."""
    if batch.adj is not None:
        return batch.adj.sum((1, 2)).long()
    return _popcount(batch.adj_bits.device)[batch.adj_bits.long()].sum((1, 2))


def batch_stats(batch: SubgraphBatch, valid: torch.Tensor):
    """(hop composition [DIM_1HOT_HOP], nodes, edges, subgraphs) of the
    subgraphs of ``batch`` whose ``valid`` [B] is set, as device
    tensors (f64 composition, int64 counts)."""
    m = batch.node_mask & valid[:, None]
    hops = (hop2onehot(batch.hop).double() * m[..., None]).sum((0, 1))
    return (hops, (batch.size * valid).sum(), (batch_edges(batch) * valid).sum(),
            valid.sum())


class SubgraphProfiler:
    """Per-branch totals of the hop composition, nodes, edges and
    subgraphs; ``enabled`` turns it on and off."""

    def __init__(self, num_ensemble: int):
        self.num_ensemble = num_ensemble
        self.clear_metrics()

    def clear_metrics(self):
        self.hop_comp: List[np.ndarray] = [
            np.zeros(DIM_1HOT_HOP) for _ in range(self.num_ensemble)]
        self.num_subg = [0] * self.num_ensemble
        self.num_nodes = [0.0] * self.num_ensemble
        self.num_edges = [0.0] * self.num_ensemble
        self.enabled = True

    def update_stats(self, i: int, hop_comp, num_nodes: float, num_edges: float,
                     num_subg: int):
        """Add branch ``i``'s reduced statistics."""
        if not self.enabled:
            return
        self.hop_comp[i] += np.asarray(hop_comp)
        self.num_nodes[i] += float(num_nodes)
        self.num_edges[i] += float(num_edges)
        self.num_subg[i] += int(num_subg)

    def update_batch(self, batches: List[SubgraphBatch]):
        """Add one batch of every branch (all its subgraphs)."""
        if not self.enabled:
            return
        for i, b in enumerate(batches):
            hops, nodes, edges, n = batch_stats(
                b, torch.ones(b.nodes.shape[0], dtype=torch.bool,
                              device=b.nodes.device))
            self.update_stats(i, hops.cpu().numpy(), nodes.item(), edges.item(),
                              n.item())

    def summary(self) -> Dict[str, List]:
        out = {"avg_nodes": [], "avg_edges": [], "avg_deg": [],
               "hop_composition": []}
        for i in range(self.num_ensemble):
            ns = max(self.num_subg[i], 1)
            out["avg_nodes"].append(self.num_nodes[i] / ns)
            out["avg_edges"].append(self.num_edges[i] / ns)
            out["avg_deg"].append(self.num_edges[i] / max(self.num_nodes[i], 1.0))
            tot = max(self.hop_comp[i].sum(), 1.0)
            out["hop_composition"].append((self.hop_comp[i] / tot).tolist())
        return out

    def print_summary(self):
        if not self.enabled or max(self.num_subg) == 0:
            return
        s = self.summary()
        hdr = ["branch", "avg nodes", "avg edges", "avg deg"]
        print(" | ".join(f"{h:>10s}" for h in hdr))
        for i in range(self.num_ensemble):
            print(" | ".join([f"{i:>10d}", f"{s['avg_nodes'][i]:>10.1f}",
                              f"{s['avg_edges'][i]:>10.1f}",
                              f"{s['avg_deg'][i]:>10.2f}"]))
            hc = s["hop_composition"][i]
            labels = ["unreach/far", "self"] + [f"{h}-hop"
                                                for h in range(1, len(hc) - 1)]
            print("  hops: " + ", ".join(f"{l}={v:.3f}" for l, v in zip(labels, hc)))
