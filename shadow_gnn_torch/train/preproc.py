"""Graph preprocessing: feature smoothening and label-as-feature inputs.

The port of ``shadow_gnn_tpu/train/preproc.py`` (reference
``shaDow/preproc.py``): SGC/SIGN-style smoothening (sym-K / rw-K with
concat, sum or last reduction) and the APPNP-style ``ppr--...``
iteration with its convergence check, over the full graph (the
transductive ``full`` preprocess sampler, or per mode for inductive
data); and the one-hot TRAIN (+VALID) labels as input features.  The
propagation runs on the trainer's device through ``ops/spmm.py``; edge
lists and normalisation are built on the host.  Preprocessing inside
sampled subgraphs (``smooth_signal_subgraph``, a preprocess sampler
other than ``full``) is used by no shipped config and is not ported.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from shadow_gnn_torch import TEST, TRAIN, VALID
from shadow_gnn_torch.ops.spmm import csr_to_edges, spmm_edges
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


def smooth_signal_full(indptr, indices, signal: np.ndarray, type_norm: str,
                       order: int, reduction: str, args: Dict,
                       device="cpu") -> Tuple[np.ndarray, int]:
    """Full-graph smoothening (preproc.py:143-165) on ``device``.
    Returns (smoothed signal, propagation steps taken)."""
    n = indptr.size - 1
    x = torch.as_tensor(signal.astype(np.float32), device=device)

    def make_sp(src, dst, val):
        s, d, v = (torch.as_tensor(a, device=device) for a in (src, dst, val))
        s, d = s.long(), d.long()
        return lambda z: spmm_edges(s, d, v, z, n)

    if type_norm == "ppr":
        alpha_int = 1.0 - args["alpha"]     # flipped like preproc.py:28
        sp = make_sp(*_norm_edges(indptr, indices, args["norm_adj"],
                                  add_self_edge=args["norm_adj"] == "sym"))
        h = z = x
        steps = 0
        for _ in range(args["itr_max"]):
            zk = (1 - alpha_int) * sp(z) + alpha_int * h
            delta = float(torch.linalg.vector_norm(z - zk))
            z = zk
            steps += 1
            if delta < args["thres"]:
                break
        z_np = z.cpu().numpy()
        nf = args["norm_feat"]
        if nf == "l1":
            z_np = z_np / np.clip(np.abs(z_np).sum(1, keepdims=True), 1e-5, None)
        elif nf == "max":
            z_np = z_np / z_np.max()
        elif nf != "none":
            raise NotImplementedError(nf)
        if reduction in ("cat", "concat"):
            return np.concatenate([signal, z_np], axis=1), steps
        if reduction == "sum":
            return signal + z_np, steps
        return z_np, steps     # 'last'
    sp = make_sp(*_norm_edges(indptr, indices, type_norm, add_self_edge=False))
    outs = [x.cpu().numpy()]
    cur = x
    for _ in range(order):
        cur = sp(cur)
        outs.append(cur.cpu().numpy())
    if reduction in ("cat", "concat"):
        return np.concatenate(outs, axis=1), order
    if reduction == "sum":
        return np.sum(np.stack(outs, 0), 0), order
    return outs[-1], order     # 'last'


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
    if preproc_cfgs and preproc_cfgs[0]["method"] != "full":
        raise NotImplementedError(
            "smooth_signal_subgraph (a preprocess sampler other than 'full') "
            "is not ported yet")
    indptr, indices = trainer._host_adj[TEST]
    log: Dict[str, float] = {}

    def smooth(signal, cfg_str, what):
        t0 = time.perf_counter()
        tn, order, red, args = decode_smoothen_config(cfg_str)
        if trainer.is_transductive:
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
