"""Correct & Smooth post-processing: the smooth step over the full graph.

The port of the JAX package's ``postproc/cns.py`` (reference
``shaDow/postproc_CnS.py``): reverse edges and self loops are added to
the stored graph (duplicates kept, as DGL keeps them), then 50 steps of
``y <- alpha * mean_in(y) + (1 - alpha) * y0`` with the optional
D^{-1/2} / D^{1/2} scaling around the mean and a clamp to [0, 1]; the
TRAIN rows of y0 are their one-hot labels.

The mean over in-edges is built once, on the host, as a CSR matrix
(duplicate edges summed into one weight, which gives DGL's mean) and
applied with ``torch.sparse.mm``: the scratch of a step is a few ``y``
tables, not one row per edge.  On CUDA the product is cuSPARSE's; the
JAX package computes it with XLA's ``segment_sum``, not with a TPU
kernel.  JAX jits the 50 steps as one ``lax.scan``; here they are one
CUDA graph on a card (:class:`Propagation`, ``train/graphs.py``), whose
input ``y0`` is a static buffer: a key's first call is its eager
warm-up (cuSPARSE sizes and allocates its workspace there), the second
is captured, later ones replay.  With ``n_shards`` > 0 the propagation
is edge-partitioned over a process group of that many ranks
(``parallel/edgepart.py:make_outcome_correlation``, the ring SpMM),
graphed the same way on an NCCL group: the library functions raise by
name outside such a group, except at ``n_shards`` 1, which runs in this
process, and :func:`run_correct_smooth` spawns the ranks itself when it
is called outside one.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from shadow_gnn_torch import TEST, TRAIN, VALID
from shadow_gnn_torch.train.graphs import StepGraphs

N_PROP = 50


def _cs_edges(indptr: np.ndarray, indices: np.ndarray):
    """(src, dst) int32: the graph's edges, their reverses and one self
    loop a node (postproc_CnS.py:33-47); the stored self loops are
    dropped and duplicates kept."""
    n = indptr.size - 1
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = indices.astype(np.int32)
    no_self = src != dst
    s2 = np.concatenate([src, dst, np.arange(n, dtype=np.int32)])
    d2 = np.concatenate([dst, src, np.arange(n, dtype=np.int32)])
    keep = np.concatenate([no_self, no_self, np.ones(n, bool)])
    return s2[keep], d2[keep]


def mean_operator(indptr: np.ndarray, indices: np.ndarray, device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, in_deg) on ``device``: A [n, n] the CSR mean over in-edges of
    :func:`_cs_edges` (row v holds 1 / in_deg[v] at each source u of an
    edge u -> v, duplicates summed), in_deg [n] f32 clipped to 1."""
    n = indptr.size - 1
    src, dst = _cs_edges(indptr, indices)
    in_deg = np.clip(np.bincount(dst, minlength=n).astype(np.float32), 1.0, None)
    val = (1.0 / in_deg[dst]).astype(np.float32)
    a = sp.csr_matrix((val, (dst, src)), shape=(n, n), dtype=np.float32)
    a.sum_duplicates()
    dev = torch.device(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
        op = torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr.astype(np.int64)),
            torch.as_tensor(a.indices.astype(np.int64)),
            torch.as_tensor(a.data), size=(n, n), check_invariants=False).to(dev)
    return op, torch.as_tensor(in_deg, device=dev)


def propagate(op: torch.Tensor, in_deg: torch.Tensor, y0: torch.Tensor,
              n_prop: int = N_PROP, alpha: float = 0.8, use_norm: bool = False,
              clamp: Optional[Tuple[float, float]] = (0.0, 1.0)) -> torch.Tensor:
    """``n_prop`` steps of y <- alpha * A y + (1 - alpha) y0 from y0
    (with ``use_norm``: A's input scaled by in_deg^-1/2, its output by
    in_deg^1/2), each clamped to ``clamp``."""
    rs, sq = torch.rsqrt(in_deg)[:, None], torch.sqrt(in_deg)[:, None]
    y = y0
    for _ in range(n_prop):
        y = torch.sparse.mm(op, y * rs if use_norm else y)
        if use_norm:
            y = y * sq
        y = alpha * y + (1 - alpha) * y0
        if clamp is not None:
            y = torch.clamp(y, clamp[0], clamp[1])
    return y


class Propagation:
    """:func:`propagate` over one mean operator, its ``n_prop`` steps one
    CUDA graph a key ``("cs", n_prop, F, alpha, use_norm, clamp)`` on a
    card (``cuda_graphs`` False: eager).  A call's result is static on
    the graphed form: read it before the key's next call."""

    def __init__(self, op: torch.Tensor, in_deg: torch.Tensor, cuda_graphs: bool = True):
        self.op, self.in_deg = op, in_deg
        self.graphs = StepGraphs(in_deg.device, cuda_graphs)

    def __call__(self, y0: torch.Tensor, n_prop: int = N_PROP, alpha: float = 0.8,
                 use_norm: bool = False,
                 clamp: Optional[Tuple[float, float]] = (0.0, 1.0)) -> torch.Tensor:
        clamp = None if clamp is None else tuple(clamp)
        key = ("cs", n_prop, y0.shape[1], alpha, use_norm, clamp)
        buf = self.graphs.inputs(key, y0=y0.float())
        return self.graphs.run(key, (), lambda: propagate(
            self.op, self.in_deg, buf["y0"], n_prop, alpha, use_norm, clamp))


def _rank_device(device):
    """A ring's device: the rank's inside a group, else ``device``."""
    from shadow_gnn_torch.parallel import multihost as mh
    return mh.device() or device


def general_outcome_correlation(indptr, indices, y0: np.ndarray,
                                n_prop: int = N_PROP, alpha: float = 0.8,
                                use_norm: bool = False,
                                clamp: Optional[Tuple[float, float]] = (0., 1.),
                                n_shards: int = 0, device="cuda") -> np.ndarray:
    """y <- alpha * A_mean y + (1 - alpha) y0, ``n_prop`` times, on
    ``device``; returns y as f32 numpy.  ``n_shards`` > 0: on a rank of
    a process group of ``n_shards`` (each rank on its own device), or in
    this process at 1, the edge-partitioned propagation; every rank gets
    the whole y."""
    if n_shards:
        from shadow_gnn_torch.parallel.edgepart import distributed_outcome_correlation
        return distributed_outcome_correlation(indptr, indices, y0, n_prop, alpha,
                                               use_norm, clamp, n_devices=n_shards,
                                               device=_rank_device(device))
    op, deg = mean_operator(indptr, indices, device)
    y0_t = torch.as_tensor(np.asarray(y0, np.float32))
    return Propagation(op, deg)(y0_t, n_prop, alpha, use_norm, clamp).cpu().numpy()


def seed_matrix(pred: np.ndarray, label: np.ndarray, train_idx: np.ndarray):
    """The prediction matrix with the TRAIN rows set to their one-hot
    labels (postproc_CnS.py:93-94)."""
    y = pred.astype(np.float32, copy=True)
    y[train_idx] = np.eye(pred.shape[1], dtype=np.float32)[label[train_idx]]
    return y


def correct_smooth(indptr, indices, label_full: np.ndarray,
                   node_set: Dict[int, np.ndarray], pred_list: List[np.ndarray],
                   use_norm: bool, alpha: float, n_shards: int = 0, device="cuda"):
    """The smooth step on each prediction matrix of ``pred_list``;
    returns (acc_orig, acc_cs): per mode, the accuracy list over the
    matrices before and after the step.  ``n_shards`` > 0: on a rank of
    a process group of ``n_shards`` (or in this process at 1), the
    edge-partitioned propagation.  Every matrix replays the
    propagation's graph once the first has warmed it up."""
    lab = label_full.astype(np.int64)
    acc_orig = {TRAIN: [], VALID: [], TEST: []}
    acc_cs = {TRAIN: [], VALID: [], TEST: []}

    def acc(y, mode):
        idx = node_set[mode]
        return float((y[idx].argmax(1) == lab[idx]).mean())

    if n_shards:
        from shadow_gnn_torch.parallel.edgepart import make_outcome_correlation
        ring = make_outcome_correlation(indptr, indices, n_shards, _rank_device(device))

        def smooth(y):
            return ring(y, N_PROP, alpha, use_norm).cpu().numpy()
    else:
        prop = Propagation(*mean_operator(indptr, indices, device))

        def smooth(y):
            return prop(torch.as_tensor(y), N_PROP, alpha, use_norm).cpu().numpy()
    for pred in pred_list:
        y = seed_matrix(pred, lab, node_set[TRAIN])
        for m in (TRAIN, VALID, TEST):
            acc_orig[m].append(acc(y, m))
        y_s = smooth(y)
        for m in (TRAIN, VALID, TEST):
            acc_cs[m].append(acc(y_s, m))
    return acc_orig, acc_cs


def run_correct_smooth(args, cfg: dict):
    """``--postproc_configs`` with ``method: cs``: the prediction matrix
    of each run dir of ``cfg["dir_pred_mat"]`` (and ``--postproc_dir``),
    stored or generated by inference, smoothed with
    ``cfg["hyperparameter"]`` (``norm_sym``, ``alpha``, ``n_shards``) on
    ``args.device``; ``n_shards`` > 0 spawns that many local ranks
    (``parallel/launch.py``: cuda:0.. or the CPU) unless this process
    already is a rank of such a group.  Prints and returns (acc_orig,
    acc_cs)."""
    import glob

    from shadow_gnn_torch.data.loader import load_data

    if cfg["method"].lower() != "cs":
        raise ValueError(f"not a C&S config: method {cfg['method']!r}")
    dirs = list(cfg.get("dir_pred_mat", []))
    if args.postproc_dir and args.postproc_dir not in dirs:
        dirs.append(args.postproc_dir)
    preds = []
    for d in dirs:
        cand = (sorted(glob.glob(f"{d}/pred_mat_*.npy"))
                + sorted(glob.glob(f"{d}/__pred_mat_*.npy")))
        preds.append(np.load(cand[0]) if cand else _gen_pred_mat(args, d))
    raw = load_data(args.data_dir, args.dataset,
                    {"to_undirected": True, "transductive": True})
    hp = cfg["hyperparameter"]
    n_shards = int(hp.get("n_shards", 0))
    cs_args = (raw.indptr_full, raw.indices_full, raw.label_full, raw.node_set, preds,
               hp["norm_sym"], hp["alpha"], n_shards, args.device)
    from shadow_gnn_torch.parallel import multihost as mh
    if n_shards and mh.world_size() != n_shards:
        from shadow_gnn_torch.parallel import launch
        dev = "cpu" if args.device.startswith("cpu") else "cuda"
        acc_orig, acc_cs = launch.spawn(correct_smooth, n_shards, dev, cs_args)
    else:
        acc_orig, acc_cs = correct_smooth(*cs_args)
    print("original acc:", {k: np.mean(v) for k, v in acc_orig.items()})
    print("C&S acc:     ", {k: np.mean(v) for k, v in acc_cs.items()})
    return acc_orig, acc_cs


def _gen_pred_mat(args, run_dir: str) -> np.ndarray:
    """The run's full-graph prediction matrix by inference with its
    newest checkpoint, saved as ``pred_mat_gen.npy`` in the run dir
    (reference main.py:237-249)."""
    from shadow_gnn_torch.postproc.driver import _build_trainer_from_run
    tr, _ = _build_trainer_from_run(args, run_dir)
    pred_mat = tr.predict_full()
    np.save(f"{run_dir}/pred_mat_gen.npy", pred_mat)
    return pred_mat
