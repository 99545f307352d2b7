"""shaDow-GAT (the reference code's ``GATConv``, ``ResPool`` and label
inputs; Zeng et al., NeurIPS 2021) in plain PyTorch over dense blocks,
for the node task with label inputs and their PPR smoothening:

    labels : y0 = one-hot TRAIN labels (zero elsewhere);
             z <- 0.8 * A_sym z + 0.2 * y0 on A + I (degrees of A + I,
             at least 1) until ||z_new - z|| < 0.015 (at most 100
             times); the node's inputs are [features, y0, z], the label
             columns zeroed at each root in TRAIN steps
    layer  : x <- dropout(x); h_s = prelu(x W_s + b_s);
             h_n = prelu(x W_n + b_n) (heads H of dh = dim / H);
             a_s = leaky_relu(h_s . att_0, 0.2), a_n = leaky_relu(h_n . att_1);
             aggregate_i = sum_j e_ij h_n[j] / sum_j e_ij,
             e_ij = exp(a_s[i] + a_n[j] - max_j) over the block's edges
             (self edges added; the max over the edges before dropedge,
             e_ij zero on a dropped edge);
             x <- ((LN_1(h_s) + LN_0(aggregate)) / 2) * node_mask, LN per head
    readout: max over the layers of the root's rows, beside max over the
             layers of each layer's max over the real nodes;
             emb = LN(prelu(dropout([root, pool]) W + b)), L2-normalised
    logits = LN(emb W_c + b_c)

Dropout, dropedge and the parameter names as in ``sage.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.sage import dropedge_keep, dropout, layer_norm

APPNP_ALPHA, APPNP_THRES, APPNP_MAX = 0.8, 0.015, 100


def label_inputs(data: Dict, device):
    """([n, 2C] f32: the TRAIN one-hot labels and their PPR smoothening
    over the full graph, the propagation steps taken)."""
    n, lab = data["indptr"].size - 1, data["label"]
    c = int(lab.max()) + 1
    y0 = torch.zeros(n, c, device=device)
    tr = torch.as_tensor(data["node_set"][0], device=device)
    y0[tr, torch.as_tensor(lab, device=device)[tr]] = 1.0
    indptr = torch.as_tensor(np.asarray(data["indptr"], np.int64), device=device)
    dst = torch.as_tensor(np.asarray(data["indices"], np.int64), device=device)
    src = torch.repeat_interleave(torch.arange(n, device=device), indptr[1:] - indptr[:-1])
    loops = torch.arange(n, device=device)
    src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
    deg = torch.clamp(torch.bincount(src, minlength=n).double(), min=1.0)
    val = (1.0 / torch.sqrt(deg[src]) / torch.sqrt(deg[dst])).float()
    z, steps = y0, 0
    for _ in range(APPNP_MAX):
        az = torch.zeros_like(z).index_add_(0, src, val[:, None] * z[dst])
        zk = APPNP_ALPHA * az + (1.0 - APPNP_ALPHA) * y0
        delta = float(torch.linalg.vector_norm(zk - z))
        z, steps = zk, steps + 1
        if delta < APPNP_THRES:
            break
    return torch.cat([y0, z], 1).cpu().numpy(), steps


def param_specs(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    arch = cfg["train_config"]["architecture"]
    dim, heads, layers = arch["dim"], int(arch["heads"]), arch["num_layers"]
    c = cfg["data"]["num_classes"]
    d = cfg["data"]["num_feat"] + 2 * c
    dh = dim // heads
    specs = []
    for l in range(layers):
        p = f"convs.{l}."
        specs += [(p + "scale", (2, heads, dh), "ones"),
                  (p + "offset", (2, heads, dh), "zeros"),
                  (p + "act.prelu_alpha", (1,), "const:0.25")]
        for lin in ("lin_self", "lin_neigh"):
            specs += [(f"{p}{lin}.weight", (dim, d), "linear"),
                      (f"{p}{lin}.bias", (dim,), f"linear:{d}")]
        specs.append((p + "attention", (2, heads, dh), "glorot"))
        d = dim
    specs += [("res_pool.scale", (dim,), "ones"), ("res_pool.offset", (dim,), "zeros"),
              ("res_pool.act.prelu_alpha", (1,), "const:0.25"),
              ("res_pool.lin.weight", (dim, 2 * dim), "linear"),
              ("res_pool.lin.bias", (dim,), f"linear:{2 * dim}"),
              ("classifier.0.scale", (c,), "ones"),
              ("classifier.0.offset", (c,), "zeros"),
              ("classifier.0.lin.weight", (c, dim), "linear"),
              ("classifier.0.lin.bias", (c,), f"linear:{dim}")]
    return specs


def _prelu(x, a):
    return torch.where(x > 0, x, a * x)


def forward(w: Dict[str, torch.Tensor], sub: Dict[str, torch.Tensor],
            feat: torch.Tensor, cfg: Dict, train: bool = False,
            gen: Optional[torch.Generator] = None, edge_seed: int = 0,
            mode_train: Optional[bool] = None) -> torch.Tensor:
    """Logits [B, C]; ``feat`` [n, F + 2C] the features with the label
    inputs; ``mode_train`` (default ``train``) zeroes the label inputs at
    the roots."""
    hyper = cfg["train_config"]["hyperparameter"]
    arch = cfg["train_config"]["architecture"]
    heads = int(arch["heads"])
    n = feat.shape[0]
    b, npad = sub["nodes"].shape
    real = sub["real"]
    mask = real[..., None].float()
    x = feat[torch.clamp(sub["nodes"], max=n - 1)] * mask
    d_lab = 2 * cfg["data"]["num_classes"]
    if train if mode_train is None else mode_train:
        at_root = torch.arange(npad, device=x.device)[None] == sub["target"][:, None]
        cols = torch.arange(x.shape[-1], device=x.device) >= x.shape[-1] - d_lab
        x = torch.where(cols & at_root[..., None], 0.0, x)
    adj = sub["adj"]
    p_edge = float(hyper.get("dropedge", 0.0))
    adj_n = adj
    if train and p_edge > 0:
        adj_n = adj * dropedge_keep(edge_seed, b, npad, p_edge, adj.device)
    p = float(hyper["dropout"])
    outs = []
    for l in range(arch["num_layers"]):
        q = f"convs.{l}."
        if train and p > 0:
            x = dropout(x, p, gen)
        a = w[q + "act.prelu_alpha"]
        h_s = _prelu(x @ w[q + "lin_self.weight"].T + w[q + "lin_self.bias"], a)
        h_n = _prelu(x @ w[q + "lin_neigh.weight"].T + w[q + "lin_neigh.bias"], a)
        h_s, h_n = h_s.view(b, npad, heads, -1), h_n.view(b, npad, heads, -1)
        att = w[q + "attention"]
        s_s = torch.nn.functional.leaky_relu(torch.einsum("bnhd,hd->bhn", h_s, att[0]), 0.2)
        s_n = torch.nn.functional.leaky_relu(torch.einsum("bnhd,hd->bhn", h_n, att[1]), 0.2)
        s = s_s[..., :, None] + s_n[..., None, :]
        s = torch.where(adj[:, None] > 0, s, float("-inf"))
        top = s.amax(-1, keepdim=True)
        top = torch.where(torch.isfinite(top), top, 0.0)
        e = torch.exp(s - top) * adj_n[:, None]
        agg = torch.matmul(e, h_n.permute(0, 2, 1, 3)) / torch.clamp(
            e.sum(-1, keepdim=True), min=1e-10)
        agg = agg.permute(0, 2, 1, 3)
        agg = layer_norm(agg, w[q + "scale"][0], w[q + "offset"][0])
        h_s = layer_norm(h_s, w[q + "scale"][1], w[q + "offset"][1])
        x = ((h_s.reshape(b, npad, -1) + agg.reshape(b, npad, -1)) / 2.0) * mask
        outs.append(x)
    rows = torch.arange(b, device=x.device)
    root = torch.stack([o[rows, sub["target"]] for o in outs]).amax(0)
    pool = torch.stack([torch.where(real[..., None], o, -1e30).amax(1) for o in outs]).amax(0)
    h = torch.cat([root, pool], -1)
    if train and p > 0:
        h = dropout(h, p, gen)
    h = _prelu(h @ w["res_pool.lin.weight"].T + w["res_pool.lin.bias"],
               w["res_pool.act.prelu_alpha"])
    emb = layer_norm(h, w["res_pool.scale"], w["res_pool.offset"])
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
    return layer_norm(emb @ w["classifier.0.lin.weight"].T + w["classifier.0.lin.bias"],
                      w["classifier.0.scale"], w["classifier.0.offset"])
