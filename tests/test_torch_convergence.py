"""PyTorch port against the JAX package: convergence over seeds.

The planted partition of ``make_planted_dataset`` (3,000 nodes, 8
communities, weak features), the same graph in both packages; three
models at test width, each trained from 5 seeds in each package for 20
epochs: the flagship's semantics (SAGE-3, PPR, hop augment, center
pooling, dropout and dropedge) on a uniform and on a power-law graph,
and the two-branch PPR + khop GAT ensemble.  Each run's best model
then gives its full-graph prediction matrix (``predict_full``), which
``correct_smooth`` smooths.  The port's mean TEST accuracy, before and
after C&S, must lie within 1 sigma of JAX's mean, sigma the larger of the
two packages' standard deviations over the seeds.  The random streams
(dropout, dropedge, khop picks, the first-epoch profile of the JAX
Trainer) differ between the packages, so only the distributions can
agree.

A link case holds the link task the same way: the planted graph's
edges split into TRAIN, VALID and TEST positives (the held-out ones
leave the message graph, as ogbl-collab's do), random VALID/TEST
negatives; the collab model's kind at test width (SAGE-2, ppr_st, DRNL
one-hots concatenated, concat residue, sort pooling), 5 seeds a package;
the port's mean TEST hits@20 within 1 sigma of JAX's."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from shadow_gnn_tpu.data.synthetic import make_planted_dataset as j_planted
from shadow_gnn_tpu.postproc import cns as jcns
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch import TEST
from shadow_gnn_torch.data import make_planted_dataset as t_planted
from shadow_gnn_torch.postproc import cns as tcns
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import Trainer as TTrainer

torch.set_num_threads(2)
SEEDS = range(5)
EPOCHS = 20
GRAPH = dict(num_nodes=3000, num_classes=8, avg_deg=15.0, seed=0)
SAGE = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 32, "aggr": "sage", "loss": "softmax", "num_layers": 3,
                     "act": "relu", "feature_augment": "hops", "residue": "none",
                     "pooling": "center"},
    "hyperparameter": {"end": EPOCHS, "lr": 5e-3, "dropout": 0.2, "dropedge": 0.05,
                       "batch_size": 64},
    "sampler": [{"method": "ppr", "phase": "train", "k": [32], "epsilon": [1e-5]}],
}
ENSEMBLE = {
    "data": {"to_undirected": True, "transductive": True},
    "architecture": {"dim": 32, "aggr": "gat", "heads": 2, "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "sum", "pooling": "mean",
                     "ensemble_act": "leakyrelu"},
    "hyperparameter": {"end": EPOCHS, "lr": 5e-3, "dropout": 0.2, "dropedge": 0.05,
                       "batch_size": 64, "ensemble_dropout": "none"},
    "sampler": [{"method": "ppr", "phase": "train", "k": [32], "epsilon": [1e-5]},
                {"method": "khop", "phase": "train", "depth": [2], "budget": [6]}],
}
MODELS = {"flagship": (SAGE, False), "flagship_power_law": (SAGE, True),
          "ensemble": (ENSEMBLE, False)}
LINK_EPOCHS = 10
LINK_GRAPH = dict(num_nodes=2000, num_classes=8, avg_deg=12.0, p_in=0.9, snr=1.5, seed=0)
LINK = {
    "data": {"to_undirected": True, "transductive": True},
    "architecture": {"dim": 32, "aggr": "sage", "loss": "sigmoid", "num_layers": 2,
                     "act": "elu", "feature_augment": "drnls",
                     "feature_augment_ops": "concat", "residue": "concat",
                     "pooling": "sort-8"},
    "hyperparameter": {"end": LINK_EPOCHS, "lr": 5e-3, "dropout": 0.1,
                       "dropedge": 0.05, "batch_size": 32,
                       "percent_per_epoch": {"train": 0.5, "valid": 1, "test": 1}},
    "sampler": [{"method": "ppr_st", "phase": "train", "k": [16],
                 "threshold": [0.01], "epsilon": [1e-5]}],
}


def _smoothed(raw, pred):
    """(C&S TEST accuracy of the prediction matrix, by the JAX package's
    function and by the port's, which must agree)."""
    args = (raw.indptr_full, raw.indices_full, raw.label_full, raw.node_set, [pred],
            False, 0.8)
    want = jcns.correct_smooth(*args)[1][TEST][0]
    got = tcns.correct_smooth(*args, device="cpu")[1][TEST][0]
    assert got == want
    return got


def _run(package, cfg, raw, seed):
    """(TEST accuracy of the best model, its C&S TEST accuracy)."""
    if package == "jax":
        m = JMetrics("planted", False, "accuracy", 1)
        tr = JTrainer("planted", "", raw, j_parse(cfg), m, JLogger(m, "", no_log=True),
                      seed=seed, use_device_ppr=False)
    else:
        tr = TTrainer("planted", "", raw, t_parse(cfg), seed=seed, device="cpu")
    tr.train()
    return tr.logger.final_stats[TEST]["accuracy"], _smoothed(raw, tr.predict_full())


@pytest.mark.slow
@pytest.mark.parametrize("model", list(MODELS))
def test_convergence_within_one_sigma_of_jax(model):
    cfg, power_law = MODELS[model]
    (raw_t, ceil_t), (raw_j, ceil_j) = (t_planted(**GRAPH, power_law=power_law),
                                        j_planted(**GRAPH, power_law=power_law))
    assert ceil_t == ceil_j
    t0 = time.time()
    acc = {pkg: np.array([_run(pkg, cfg, raw, s) for s in SEEDS])
           for pkg, raw in (("jax", raw_j), ("torch", raw_t))}
    secs = time.time() - t0
    for col, what in ((0, "TEST"), (1, "C&S TEST")):
        mean = {p: float(a[:, col].mean()) for p, a in acc.items()}
        sigma = max(float(a[:, col].std()) for a in acc.values())
        print(f"[convergence] {model} {what}: port {mean['torch']:.4f} "
              f"(std {acc['torch'][:, col].std():.4f}), JAX {mean['jax']:.4f} "
              f"(std {acc['jax'][:, col].std():.4f}), sigma {sigma:.4f}; "
              f"feature-only ceiling {ceil_t:.4f}; {len(SEEDS)} seeds each, "
              f"{secs:.0f}s")
        assert abs(mean["torch"] - mean["jax"]) <= sigma, (model, what, mean, sigma)
    # the models learn the planted structure beyond the features alone
    assert acc["torch"][:, 0].mean() > ceil_t + 0.1


def _link_splits(raw, n_pos=(1600, 200, 200)):
    """The planted graph as a link dataset, the way ``make_synthetic_dataset
    (task="link")`` splits its graph: positives drawn from the undirected
    edges, random VALID/TEST negatives, the VALID and TEST positives
    removed from the message graph (numpy, the same for either
    package's RawGraph)."""
    rng = np.random.default_rng(7)
    n = raw.num_nodes
    src = np.repeat(np.arange(n), np.diff(raw.indptr_full))
    dst = raw.indices_full.astype(np.int64)
    pool = np.stack([src[src < dst], dst[src < dst]], 1)
    sel = rng.permutation(pool.shape[0])
    edge_set, ofs = {}, 0
    for m, cnt in enumerate(n_pos):
        pos = pool[sel[ofs:ofs + cnt]]
        ofs += cnt
        edge_set[m] = {"pos": pos} if m == 0 else {
            "pos": pos, "neg": rng.integers(0, n, pos.shape).astype(np.int64)}
    held = np.concatenate([edge_set[1]["pos"], edge_set[2]["pos"]])
    drop = np.isin(src * n + dst, np.r_[held[:, 0] * n + held[:, 1],
                                        held[:, 1] * n + held[:, 0]])
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src[~drop], minlength=n))])
    return dataclasses.replace(raw, indptr_full=indptr.astype(raw.indptr_full.dtype),
                               indices_full=raw.indices_full[~drop], label_full=None,
                               node_set=None, edge_set=edge_set)


def _run_link(package, raw, seed):
    """TEST hits@20 of the best model."""
    if package == "jax":
        m = JMetrics("planted", True, "hits20", 1)
        tr = JTrainer("planted", "", raw, j_parse(LINK), m, JLogger(m, "", no_log=True),
                      seed=seed, use_device_ppr=False)
    else:
        from shadow_gnn_torch.train.metrics import Metrics
        tr = TTrainer("planted", "", raw, t_parse(LINK),
                      Metrics("planted", True, "hits20", 1), seed=seed, device="cpu")
    tr.train()
    return tr.logger.final_stats[TEST]["hits20"]


@pytest.mark.slow
def test_link_convergence_within_one_sigma_of_jax():
    raw_t, raw_j = (_link_splits(t_planted(**LINK_GRAPH)[0]),
                    _link_splits(j_planted(**LINK_GRAPH)[0]))
    np.testing.assert_array_equal(raw_t.indices_full, raw_j.indices_full)
    t0 = time.time()
    hits = {pkg: np.array([_run_link(pkg, raw, s) for s in SEEDS])
            for pkg, raw in (("jax", raw_j), ("torch", raw_t))}
    mean = {p: float(a.mean()) for p, a in hits.items()}
    sigma = max(float(a.std()) for a in hits.values())
    print(f"[convergence] link TEST hits20: port {mean['torch']:.4f} (std "
          f"{hits['torch'].std():.4f}), JAX {mean['jax']:.4f} (std "
          f"{hits['jax'].std():.4f}), sigma {sigma:.4f}; {len(SEEDS)} seeds each, "
          f"{LINK_EPOCHS} epochs, {time.time() - t0:.0f}s")
    assert abs(mean["torch"] - mean["jax"]) <= sigma, (mean, sigma)
    # the model finds the planted links: well above a random ranking
    assert hits["torch"].mean() > 0.3, hits
