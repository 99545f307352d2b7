"""The yardstick's arithmetic: the card's published peaks and the
operations and bytes of the model and of each hand-written kernel.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity), at the full
700 W power limit; a run prints the card's limit beside every share.

Operations: shaDow-GNN's per-layer count (the reference's
``complexity()`` methods, as the program's ``train/complexity.py``
copies them), which counts a multiply-add as one operation; ``FLOPS``
doubles it.  A training step is three forwards (the backward's two
products a forward product).

Bytes of a kernel: each input read once and the output written once.
"""
from __future__ import annotations

import math
from typing import Dict

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # f32 outside the tensor cores
HOP_DIM = 7


def conv_ops(aggr: str, heads: int, dim: int, n: float, e: float, f_in: int) -> float:
    """Multiply-adds of one conv layer on subgraphs of n nodes, e edges."""
    f = dim
    if aggr == "sage":
        return n * f_in * f * 2 + e * f_in
    if aggr in ("gat", "gatscat"):
        return 2 * n * f_in * f + 2 * n * f + heads * (2 * e + 20 * e) + e * f
    raise ValueError(f"no operation count for {aggr!r}")


def respool_ops(pool: str, residue: str, dim: int, layers: int, roots: float,
                nodes: float) -> float:
    f = dim
    ops = 0.0
    if pool in ("mean", "max", "sum"):
        ops += nodes * f * (1 if residue == "none" else layers)
        ops += roots * 2 * f * (layers if residue in ("cat", "concat") else 1) * f
    elif residue != "none":
        ops += roots * f * (layers if residue in ("cat", "concat") else 1) * f
    return ops


def forward_flops(cfg: Dict, nodes: float, edges: float) -> float:
    """FLOPs of one forward of a subgraph of ``nodes`` nodes and
    ``edges`` edges (means over the cell's subgraphs)."""
    arch = cfg["train_config"]["architecture"]
    dim, layers = arch["dim"], arch["num_layers"]
    f_in = cfg["data"]["num_feat"] + cfg.get("label_inputs", 0)
    ops = 0.0
    if arch.get("feature_augment", "hops") == "hops":
        ops += nodes * HOP_DIM * f_in
    for _ in range(layers):
        ops += conv_ops(arch["aggr"], max(1, int(arch.get("heads", 1))), dim, nodes,
                        edges, f_in)
        f_in = dim
    ops += respool_ops(arch["pooling"], arch["residue"], dim, layers, 1.0, nodes)
    ops += dim * cfg["data"]["num_classes"]
    return 2.0 * ops


def packed_bytes(b: int, n: int, f: int) -> int:
    """One launch of either direction of the packed aggregation: the
    bits, x (or g) read, the output written (f32)."""
    return b * n * math.ceil(n / 8) + 2 * b * n * f * 4


def bound_s(byts: float, flops: float = 0.0) -> float:
    return max(byts / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
