"""shaDow-SAGE (Zeng et al., "Decoupling the Depth and Scope of Graph
Neural Networks", NeurIPS 2021; the reference code's ``layers.py``), in
plain PyTorch over dense blocks, for the node task:

    x      = features (zero on padding) + Linear_hops(one-hot hop)
    layer  : x <- dropout(x);  h_s = relu(x W_s + b_s);
             h_n = relu((A_rw x) W_n + b_n);
             x <- (LN_0(h_s) + LN_1(h_n)) * node_mask
    readout: the root's row of the last layer, L2-normalised (center
             pooling, no residue)
    logits = LN(emb W_c + b_c)

``A_rw`` is the block with each row divided by its degree (at least 1)
after dropedge; LN is the per-row affine layer norm (biased variance,
1e-9 inside the root).  Dropout keeps an entry where a uniform draw of
the step's generator is below 1 - p (one draw of the input's shape a
layer, in layer order) and scales it by 1 / (1 - p); dropedge keeps
edge (i, j) of block b where the counter hash of (seed, b, i, j) exceeds
p (2^32 - 1): the draws and the hash that the program documents, so
that a training step sees the same masks on both sides.

Parameters are named as the program's ``state_dict`` names them, so
that one set of weights from ``gen.make_weights`` serves both.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

HOP_DIM = 7         # unreachable, self, hops 1..5
M32 = 0xFFFFFFFF


def param_specs(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter of the configuration."""
    arch = cfg["train_config"]["architecture"]
    f_in, dim = cfg["data"]["num_feat"], arch["dim"]
    specs = []
    if arch.get("feature_augment", "hops") == "hops":
        specs += [("aug.hops.weight", (f_in, HOP_DIM), "linear"),
                  ("aug.hops.bias", (f_in,), f"linear:{HOP_DIM}")]
    d = f_in
    for l in range(arch["num_layers"]):
        p = f"convs.{l}."
        specs += [(p + "scale", (2, dim), "ones"), (p + "offset", (2, dim), "zeros")]
        for lin in ("lin_self", "lin_neigh"):
            specs += [(f"{p}{lin}.weight", (dim, d), "linear"),
                      (f"{p}{lin}.bias", (dim,), f"linear:{d}")]
        d = dim
    c = cfg["data"]["num_classes"]
    specs += [("classifier.0.scale", (c,), "ones"),
              ("classifier.0.offset", (c,), "zeros"),
              ("classifier.0.lin.weight", (c, dim), "linear"),
              ("classifier.0.lin.bias", (c,), f"linear:{dim}")]
    return specs


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropedge_keep(seed: int, b: int, n: int, p: float, device) -> torch.Tensor:
    """[b, n, n] f32 keep mask of blocks 0..b-1 under ``seed``."""
    key = _mix32((_mix32(torch.tensor(seed & M32, device=device))
                  + torch.arange(b, device=device)) & M32)
    idx = torch.arange(n, device=device)
    h = _mix32(key[:, None, None] ^ ((idx[:, None] << 16) | idx[None, :])[None])
    return (h > int(p * (2**32 - 1))).float()


def dropout(x: torch.Tensor, p: float, gen: torch.Generator) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True) + 1e-9
    return (x - mean) * scale * torch.rsqrt(var) + offset


def hop_onehot(hop: torch.Tensor) -> torch.Tensor:
    """[B, N, 7]: column 0 unreachable, column h + 1 for hop h <= 5, a
    zero row beyond."""
    col = torch.where(hop < 0, 0, hop + 1)
    return (col[..., None] == torch.arange(HOP_DIM, device=hop.device)).float()


def forward(w: Dict[str, torch.Tensor], sub: Dict[str, torch.Tensor],
            feat: torch.Tensor, cfg: Dict, train: bool = False,
            gen: Optional[torch.Generator] = None, edge_seed: int = 0) -> torch.Tensor:
    """Logits [B, C] of the subgraphs ``sub`` (``subgraph.build``);
    ``feat`` [n, F] the feature table.  In training, dropout draws from
    ``gen`` and dropedge hashes ``edge_seed``."""
    hyper = cfg["train_config"]["hyperparameter"]
    arch = cfg["train_config"]["architecture"]
    n = feat.shape[0]
    mask = sub["real"][..., None].float()
    x = feat[torch.clamp(sub["nodes"], max=n - 1)] * mask
    if "aug.hops.weight" in w:
        x = x + (hop_onehot(sub["hop"]) * mask) @ w["aug.hops.weight"].T + w["aug.hops.bias"]
    adj = sub["adj"]
    p_edge = float(hyper.get("dropedge", 0.0))
    if train and p_edge > 0:
        adj = adj * dropedge_keep(edge_seed, adj.shape[0], adj.shape[1], p_edge, adj.device)
    adj = adj / torch.clamp(adj.sum(-1, keepdim=True), min=1.0)
    p = float(hyper["dropout"])
    for l in range(arch["num_layers"]):
        q = f"convs.{l}."
        if train and p > 0:
            x = dropout(x, p, gen)
        h_s = torch.relu(x @ w[q + "lin_self.weight"].T + w[q + "lin_self.bias"])
        h_n = torch.relu(torch.bmm(adj, x) @ w[q + "lin_neigh.weight"].T
                         + w[q + "lin_neigh.bias"])
        x = (layer_norm(h_s, w[q + "scale"][0], w[q + "offset"][0])
             + layer_norm(h_n, w[q + "scale"][1], w[q + "offset"][1])) * mask
    emb = x[torch.arange(x.shape[0], device=x.device), sub["target"]]
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
    return layer_norm(emb @ w["classifier.0.lin.weight"].T + w["classifier.0.lin.bias"],
                      w["classifier.0.scale"], w["classifier.0.offset"])
