"""Graph preprocessing: feature smoothening and label-as-feature inputs.

The port of ``shadow_gnn_tpu/train/preproc.py`` (reference
``shaDow/preproc.py``): SGC/SIGN-style smoothening (sym-K / rw-K with
concat, sum or last reduction) and the APPNP-style ``ppr--...``
iteration with its convergence check, over the full graph (the
transductive ``full`` preprocess sampler, or per mode for inductive
data), or inside sampled subgraphs (:func:`smooth_signal_subgraph`, a
preprocess sampler other than ``full``); and the one-hot TRAIN (+VALID)
labels as input features.  The full-graph propagation runs on the
trainer's device through ``ops/spmm.py`` (edge lists and normalisation
built on the host), the subgraph one as dense products over the
sampled blocks.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from shadow_gnn_torch import TEST, TRAIN, VALID
from shadow_gnn_torch.data.graph import DeviceGraph
from shadow_gnn_torch.ops.normalize import adj_norm_rw, adj_norm_sym
from shadow_gnn_torch.ops.spmm import csr_to_edges, spmm_edges
from shadow_gnn_torch.sampling import ppr as ppr_mod
from shadow_gnn_torch.sampling.batch import SamplerConfig, default_n_pad
from shadow_gnn_torch.sampling.samplers import PPRTables, sample_subgraphs
from shadow_gnn_torch.train.config import decouple_ensemble


def decode_smoothen_config(config_str: str):
    """preproc.py:271-297 config-string decoder.

    'sym-2-concat' -> ('sym', 2, 'concat', {})
    'ppr--concat-0.8-sym-none-0.015-100' -> ('ppr', 1, 'concat',
        {'alpha': 0.8, 'norm_adj': 'sym', 'norm_feat': 'none',
         'thres': 0.015, 'itr_max': 100})
    """
    parts = config_str.split("-")
    type_norm = parts[0].lower()
    if type_norm == "ppr":
        if not 4 <= len(parts) <= 8:
            raise ValueError(f"bad smoothen config {config_str!r}")
        args = {"alpha": float(parts[3]), "norm_adj": "sym", "norm_feat": "none",
                "thres": 0.015, "itr_max": 100}
        if len(parts) >= 5:
            args["norm_adj"] = parts[4]
        if len(parts) >= 6:
            args["norm_feat"] = parts[5]
        if len(parts) == 7:
            args["thres"] = float(parts[6])
        if len(parts) == 8:
            args["itr_max"] = int(parts[7])
        return "ppr", 1, parts[2], args
    if len(parts) != 3:
        raise ValueError(f"bad smoothen config {config_str!r}")
    return type_norm, int(parts[1]), parts[2], {}


def _norm_edges(indptr, indices, type_norm: str, add_self_edge: bool = False):
    """Edge list of the normalised full adjacency (host, numpy)."""
    n = indptr.size - 1
    src, dst, val = csr_to_edges(indptr, indices)
    if add_self_edge:
        # append the self loops absent from the graph (APPNP's A + I)
        has_self = np.zeros(n, bool)
        has_self[src[src == dst]] = True
        extra = np.where(~has_self)[0].astype(np.int32)
        src = np.concatenate([src, extra])
        dst = np.concatenate([dst, extra])
        val = np.concatenate([val, np.ones(extra.size, np.float32)])
    deg = np.zeros(n, np.float64)
    np.add.at(deg, src, val)
    deg = np.clip(deg, 1.0, None)
    if type_norm == "sym":
        val = val / np.sqrt(deg[src]) / np.sqrt(deg[dst])
    elif type_norm == "rw":
        val = val / deg[src]
    else:
        raise NotImplementedError(type_norm)
    return src, dst, val.astype(np.float32)


def _reduce(outs, reduction: str) -> torch.Tensor:
    if reduction in ("cat", "concat"):
        return torch.cat(outs, dim=1)
    if reduction == "sum":
        return sum(outs[1:], outs[0])
    return outs[-1]     # 'last'


def _propagate(x: torch.Tensor, product, type_norm: str, order: int,
               reduction: str, args: Dict, rows) -> Tuple[torch.Tensor, int]:
    """The smoothened ``rows(...)`` of the signal ``x`` and the
    propagation steps taken: K products by the normalised adjacency
    (``product``), or the APPNP iteration with its convergence checked
    on the change of the whole ``x``, then ``norm_feat``; the reduction
    over the input and the propagated rows."""
    if type_norm != "ppr":
        outs, cur = [rows(x)], x
        for _ in range(order):
            cur = product(cur)
            outs.append(rows(cur))
        return _reduce(outs, reduction), order
    alpha_int = 1.0 - args["alpha"]     # flipped like preproc.py:28
    z, steps = x, 0
    for _ in range(args["itr_max"]):
        zk = (1 - alpha_int) * product(z) + alpha_int * x
        delta = float(torch.linalg.vector_norm(zk - z))
        z = zk
        steps += 1
        if delta < args["thres"]:
            break
    z = rows(z)
    nf = args["norm_feat"]
    if nf == "l1":
        z = z / torch.clamp(z.abs().sum(1, keepdim=True), min=1e-5)
    elif nf == "max":
        z = z / z.max()
    elif nf != "none":
        raise NotImplementedError(nf)
    return _reduce([rows(x), z], reduction), steps


def smooth_signal_full(indptr, indices, signal: np.ndarray, type_norm: str,
                       order: int, reduction: str, args: Dict,
                       device="cuda", n_shards: int = 0) -> Tuple[np.ndarray, int]:
    """Full-graph smoothening (preproc.py:143-165) on ``device`` (the
    card unless the caller asks for the CPU), each propagated signal
    kept on the host.  ``n_shards`` > 0 runs every product as the ring
    SpMM over a process group of that many ranks, or in this process at
    1 (``parallel/edgepart.py:make_ring_spmm``, a replay of its graph
    after the first product; raises outside a group of more), each rank
    on its own device.  The ppr iteration reads its change on the host
    after each product, as JAX's does.  Returns (smoothed signal,
    propagation steps taken)."""
    n = indptr.size - 1
    norm = args["norm_adj"] if type_norm == "ppr" else type_norm
    edges = _norm_edges(indptr, indices, norm,
                        add_self_edge=type_norm == "ppr" and norm == "sym")
    if n_shards:
        from shadow_gnn_torch.parallel.edgepart import make_ring_spmm
        from shadow_gnn_torch.parallel import multihost as mh
        device = mh.device() or device
        product = make_ring_spmm(edges[0].astype(np.int64), edges[1].astype(np.int64),
                                 edges[2], n, n_shards, device)
    else:
        src, dst, val = (torch.as_tensor(a, device=device) for a in edges)
        src, dst = src.long(), dst.long()

        def product(z):
            return spmm_edges(src, dst, val, z, n)
    x = torch.as_tensor(signal.astype(np.float32), device=device)
    out, steps = _propagate(x, product, type_norm, order, reduction, args,
                            lambda z: z.cpu())
    return out.numpy(), steps


def smooth_signal_per_mode(trainer, signal: np.ndarray, type_norm: str,
                           order: int, reduction: str,
                           args: Dict) -> Tuple[np.ndarray, int]:
    """Inductive per-mode smoothening (preproc.py:167-202): VALID/TEST
    rows over the full adjacency, TRAIN rows over the TRAIN adjacency;
    rows outside every split stay zero.  Returns (signal, the steps of
    both passes)."""
    if trainer.task != "node":
        raise NotImplementedError("inductive smoothening is node-task only")
    out, steps = None, 0
    groups = [((VALID, TEST), trainer._host_adj[TEST]),
              ((TRAIN,), trainer._host_adj[TRAIN])]
    for modes, (indptr, indices) in groups:
        sm, k = smooth_signal_full(indptr, indices, signal, type_norm, order,
                                   reduction, args, trainer.device)
        steps += k
        if out is None:
            out = np.zeros((trainer.num_nodes, sm.shape[1]), np.float32)
        for m in modes:
            ent = np.asarray(trainer.entity_set[m])
            out[ent] = sm[ent]
    return out, steps


def _norm_block(batch, type_norm: str, args: Dict) -> torch.Tensor:
    """The normalised block of a sampled subgraph: for ``ppr`` under
    ``norm_adj: sym`` the self-edge-augmented A + I (set semantics: an
    existing self edge stays 1) sym-normalised, else sym or rw of the
    block as sampled (no self edges added)."""
    adj = batch.adj
    if type_norm == "ppr" and args.get("norm_adj", "sym") == "sym":
        eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
        return adj_norm_sym(torch.maximum(adj, eye * batch.node_mask[..., None]))
    if type_norm == "sym":
        return adj_norm_sym(adj)
    return adj_norm_rw(adj)


def smooth_signal_subgraph(trainer, signal: np.ndarray, type_norm: str,
                           order: int, reduction: str, args: Dict,
                           cfg_dict: Dict) -> Tuple[np.ndarray, int]:
    """Smoothening inside sampled subgraphs (the JAX package's
    ``smooth_signal_subgraph``, reference preproc.py:167-202), node task
    only: per mode, ``cfg_dict``'s sampler over that mode's targets in
    batches of the trainer's size (a ``ppr``/``ppr_st`` sampler over
    that mode's own PPR push on its adjacency; the exact ``search``
    induction; the khop picks and ``ppr_st`` uniforms from a generator
    seeded 0 for every batch), the signal smoothed within each block,
    and only the target rows written back; nodes outside every split
    stay zero.  Returns (signal, the most steps a batch took)."""
    if trainer.task != "node":
        raise NotImplementedError("subgraph preprocessing is node-task only "
                                  "(the link task samples node-wise there)")
    method = cfg_dict["method"]
    cfg = SamplerConfig(
        method=method, n_pad=default_n_pad(cfg_dict, 1), num_targets=1,
        depth=int(cfg_dict.get("depth", 2)),
        budget=int(cfg_dict.get("budget", 20)),
        k=int(cfg_dict.get("k", 200)),
        alpha=float(cfg_dict.get("alpha", 0.85)),
        epsilon=float(cfg_dict.get("epsilon", 1e-5)),
        threshold=float(cfg_dict.get("threshold", 0.0)))
    dev = trainer.device
    b = trainer.batch_size
    f_in = signal.shape[1]
    f_out = f_in * (1 + order) if reduction in ("cat", "concat") else f_in
    out = np.zeros((trainer.num_nodes, f_out), np.float32)
    steps = 0
    sig_tab = torch.as_tensor(np.concatenate(
        [signal.astype(np.float32), np.zeros((1, f_in), np.float32)]), device=dev)
    for m in (TRAIN, VALID, TEST):
        indptr, indices = trainer._host_adj[m]
        graph = DeviceGraph.from_csr(indptr, indices, dev)
        targets = np.asarray(trainer.entity_set[m], dtype=np.int64)
        tables = None
        if method in ("ppr", "ppr_st"):
            k_tab = cfg.k * (2 if method == "ppr_st" else 1)
            neighs, scores = ppr_mod.ppr_push_host(indptr, indices, targets, k_tab,
                                                   cfg.alpha, cfg.epsilon)
            tab_n, tab_s = ppr_mod.ppr_topk_tables(neighs, scores, k_tab)
            tables = PPRTables(torch.as_tensor(tab_n.astype(np.int64), device=dev),
                               torch.as_tensor(tab_s, device=dev))
        n_t = targets.size
        nb = -(-n_t // b)
        pad = nb * b - n_t
        roots_all = np.concatenate([targets, np.repeat(targets[:1], pad)])
        rows_all = np.concatenate([np.arange(n_t, dtype=np.int64),
                                   np.zeros(pad, np.int64)])
        roots_d = torch.as_tensor(roots_all[:, None], device=dev)
        rows_d = torch.as_tensor(rows_all[:, None], device=dev)
        with torch.inference_mode():
            for ib in range(nb):
                sl = slice(ib * b, (ib + 1) * b)
                batch = sample_subgraphs(
                    cfg, graph, roots_d[sl], rows_d[sl], tables,
                    torch.Generator(device=dev).manual_seed(0))
                sig = (sig_tab[torch.clamp(batch.nodes, max=trainer.num_nodes)]
                       * batch.node_mask[..., None])
                an = _norm_block(batch, type_norm, args)
                tgt = (torch.arange(b, device=dev), batch.targets[:, 0])
                sm, k = _propagate(sig, lambda z: torch.bmm(an, z), type_norm,
                                   order, reduction, args, lambda z: z[tgt])
                steps = max(steps, k)
                valid = b - (pad if ib == nb - 1 else 0)
                out[roots_all[sl][:valid]] = sm.cpu().numpy()[:valid]
    return out, steps


def prepare_raw_label(label_np: np.ndarray, entity_set, use_label: str,
                      num_nodes: int) -> np.ndarray:
    """One-hot TRAIN (+VALID for 'all') labels as input features
    (preproc.py:206-225); every other row is zero."""
    if use_label == "none":
        raise ValueError("prepare_raw_label needs use_label 'all' or 'no_valid'")
    modes = [TRAIN] if use_label != "all" else [TRAIN, VALID]
    if label_np.ndim == 1:
        num_cls = int(label_np[~np.isnan(label_np.astype(np.float64))].max()) + 1
    else:
        num_cls = label_np.shape[1]
    feat_label = np.zeros((num_nodes, num_cls), np.float32)
    for md in modes:
        idx = np.asarray(entity_set[md])
        if label_np.ndim == 1:
            feat_label[idx, label_np[idx].astype(np.int64)] = 1.0
        else:
            feat_label[idx] = label_np[idx].astype(np.float32)
    return feat_label


def preprocess_signals(trainer) -> Tuple[np.ndarray, int, int, Dict[str, float]]:
    """Run the configured preprocessing: returns (features with the label
    inputs appended, dim_feat_smooth, dim_label_smooth, log), where log
    holds the seconds and the propagation steps of each smoothening."""
    arch = trainer.arch
    preproc_cfgs = decouple_ensemble(trainer.sampler_cfg_preproc.get("configs", []))
    if len(preproc_cfgs) > 1:
        raise ValueError("a subgraph ensemble in the preprocess phase is unsupported")
    subg_cfg = (preproc_cfgs[0] if preproc_cfgs
                and preproc_cfgs[0]["method"] != "full" else None)
    indptr, indices = trainer._host_adj[TEST]
    log: Dict[str, float] = {}

    def smooth(signal, cfg_str, what):
        t0 = time.perf_counter()
        tn, order, red, args = decode_smoothen_config(cfg_str)
        if subg_cfg is not None:
            out, steps = smooth_signal_subgraph(trainer, signal, tn, order, red,
                                                args, subg_cfg)
        elif trainer.is_transductive:
            out, steps = smooth_signal_full(indptr, indices, signal, tn, order,
                                            red, args, trainer.device)
        else:
            out, steps = smooth_signal_per_mode(trainer, signal, tn, order, red,
                                                args)
        log[f"{what}_s"] = time.perf_counter() - t0
        log[f"{what}_steps"] = steps
        return out

    feat = trainer.feat_np
    if arch["feature_smoothen"] != "none":
        feat = smooth(feat, arch["feature_smoothen"], "feature_smoothen")
    dim_feat_smooth = feat.shape[1]
    dim_label_smooth = 0
    if arch["use_label"] != "none":
        if trainer.task != "node":
            raise NotImplementedError("label inputs are node-task only")
        label_feat = prepare_raw_label(trainer.label_np, trainer.entity_set,
                                       arch["use_label"], trainer.num_nodes)
        if arch["label_smoothen"] != "none":
            label_feat = smooth(label_feat, arch["label_smoothen"], "label_smoothen")
        dim_label_smooth = label_feat.shape[1]
        feat = np.concatenate([feat, label_feat], axis=1)
    return feat.astype(np.float32), dim_feat_smooth, dim_label_smooth, log
