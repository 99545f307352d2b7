"""PyTorch port, the rest of the model matrix through the Trainer, against
the JAX package's Trainer on the same graph and seed, the port on
``device="cpu"`` (the plain versions of the kernels), weights carried
with ``params_from_flax(..., aggr=)``:

* the ``full`` train sampler, ``nodeIID`` batches of one node, for SGC
  (``sym-2-last``) and SIGN (``sym-2-concat``) on a planted graph: the
  smoothed features, and the first TRAIN step's loss and every gradient
  at dropout 0;
* GCN and GIN with ``packed_adj``: the first TRAIN step on a cached
  batch (JAX's interpret-mode Pallas kernel in ``sym`` / ``gin``), and
  SAGE's with the ``hops-pprs`` augments;
* ``--compute_complexity_only``'s count for gcn, gin and gatscat;
* ``smooth_signal_subgraph`` (a ``ppr`` preprocess sampler) for
  ``sym-2-concat``, ``rw-1-last`` and ``ppr--sum-0.8-sym-none``: the
  written rows, and zero rows outside every split;
* the CLI: ``--fused_gat off`` trains a toy GAT to the final stats of
  ``auto``.

f32 at atol 1e-5 / rtol 1e-4 (gradients atol 1e-6); integers exact."""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from shadow_gnn_tpu import TRAIN as J_TRAIN, VALID as J_VALID
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.data.synthetic import make_planted_dataset as j_planted
from shadow_gnn_tpu.train import preproc as jpre
from shadow_gnn_tpu.train.complexity import compute_complexity as j_complexity
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_tpu.train.pipeline import weighted_loss_fn as j_wloss
from shadow_gnn_torch import TRAIN, VALID
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.data import make_planted_dataset as t_planted
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.data import save_shadow_format
from shadow_gnn_torch.train.complexity import compute_complexity as t_complexity
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import Trainer

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = dict(num_nodes=600, avg_deg=8, num_feat=16, num_classes=5, seed=3)
PLANTED = dict(num_nodes=600, num_classes=4, avg_deg=8.0, num_feat=12, seed=1)


def _cfg(aggr, sampler, smoothen="none", dim=16, **arch):
    return {"data": {"to_undirected": False, "transductive": True},
            "architecture": {"dim": dim, "aggr": aggr, "heads": 2, "loss": "softmax",
                             "num_layers": 2, "act": "relu",
                             "feature_augment": "hops", "residue": "max",
                             "pooling": "center", "feature_smoothen": smoothen,
                             **arch},
            "hyperparameter": {"end": 1, "lr": 1e-3, "dropout": 0.0,
                               "dropedge": 0.0, "batch_size": 32},
            "sampler": sampler}


PPR = [{"method": "ppr", "phase": "train", "k": [12], "epsilon": [1e-5]}]
FULL = [{"method": "full", "phase": "train"}]


def _trainers(cfg, planted=False, packed=False):
    """(JAX Trainer, port Trainer), the port holding JAX's weights."""
    make = (lambda pkg: (t_planted if pkg else j_planted)(**PLANTED)[0]) \
        if planted else (lambda pkg: (t_make if pkg else j_make)(**GRAPH))
    m = JMetrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", make(False), j_parse(cfg), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False,
                   packed_adj=packed)
    jtr.profiler.enabled = False
    ttr = Trainer("toy", "", make(True), t_parse(cfg), seed=0, device="cpu",
                  packed_adj=packed)
    ttr.profiler.enabled = False
    ttr.model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params),
        aggr=cfg["architecture"]["aggr"]))
    return jtr, ttr


def _first_step(jtr, ttr):
    """The first TRAIN step on the first 32 TRAIN nodes in both trainers
    (cached where the trainer caches): (JAX's loss and gradients, the
    port's, the port's batch)."""
    for tr, mode in ((jtr, J_TRAIN), (ttr, TRAIN)):
        tr._ensure_tables(mode)
        tr._ensure_caches(mode)
    b = ttr.batch_size
    ent = np.asarray(ttr.entity_set[TRAIN])[:b]
    labels = ttr.label_np[ent].astype(np.int64)
    w = np.ones(b, np.float32)
    jb, jf = jtr._sample_branch_batches(
        J_TRAIN, jnp.asarray(ent[:, None].astype(np.int32)),
        jnp.arange(b, dtype=jnp.int32)[:, None], jax.random.PRNGKey(0),
        jtr._mode_arrays(J_TRAIN))
    jcfg = jtr.model_cfg

    def lf(p):
        lg, _ = jtr.model.apply(p, jb, jf, mode_train=True, train=True)
        return j_wloss(jcfg, lg, jnp.asarray(labels), jnp.asarray(w))

    j_loss, j_grads = jax.value_and_grad(lf)(jtr.params)
    tb, tf = ttr._sample_branch_batches(
        TRAIN, torch.as_tensor(ent[:, None]), torch.arange(b)[:, None])
    ttr.model.train()
    loss, _ = ttr._forward_loss(tb, tf, torch.as_tensor(labels), torch.as_tensor(w))
    loss.backward()
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, j_grads),
                            aggr=jcfg.aggr)
    return (float(j_loss), want), (loss.item(), {
        k: p.grad for k, p in ttr.model.named_parameters()}), tb[0]


def _assert_step(j, t):
    (j_loss, want), (t_loss, got) = j, t
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("aggr,smoothen", [("sgc", "sym-2-last"),
                                           ("sign", "sym-2-concat")])
def test_full_sampler_adjacency_free_matches_jax(aggr, smoothen):
    cfg = _cfg(aggr, FULL, smoothen, feature_augment="none")
    jtr, ttr = _trainers(cfg, planted=True)
    np.testing.assert_allclose(ttr.feat_np, jtr.feat_np, rtol=1e-4, atol=1e-5)
    assert ttr.dim_feat_smooth == PLANTED["num_feat"] * (3 if aggr == "sign" else 1)
    for m in (TRAIN, VALID):
        assert ttr.branches[0]["cfg"][m].method == "nodeIID"
    j, t, batch = _first_step(jtr, ttr)
    _assert_step(j, t)
    assert batch.adj_bits is None and (batch.size == 1).all()
    assert batch.nodes.shape[1] == jtr.branches[0]["cfg"][J_TRAIN].n_pad == 8


def test_full_sampler_needs_an_adjacency_free_model():
    with pytest.raises(ValueError, match="adjacency-free"):
        Trainer("toy", "", t_make(**GRAPH), t_parse(_cfg("gcn", FULL)), seed=0,
                device="cpu")


@pytest.mark.parametrize("aggr,aug", [("gcn", "hops"), ("gin", "hops"),
                                      ("sage", "hops-pprs")])
def test_packed_first_step_matches_jax(aggr, aug):
    """A cached TRAIN batch through the packed path of both packages in
    the backbone's norm (``sym`` for GCN, with its forced self edges;
    ``gin`` for GIN); and the ``pprs`` augment, read from the cached PPR
    scores."""
    jtr, ttr = _trainers(_cfg(aggr, PPR, feature_augment=aug), packed=True)
    assert ttr.model_cfg.reads_packed_bits
    assert ttr.branches[0]["cfg"][TRAIN].add_self_edge == (aggr == "gcn")
    j, t, batch = _first_step(jtr, ttr)
    _assert_step(j, t)
    assert batch.adj is None and batch.adj_bits is not None
    if aug == "hops-pprs":
        assert ttr.model_cfg.feature_augment == ("hops", "pprs")
        assert batch.ppr.max() > 0 and t[1]["aug.pprs.weight"].abs().max() > 0


@pytest.mark.parametrize("aggr", ["gcn", "gin", "gatscat"])
def test_complexity_matches_jax(aggr):
    jtr, ttr = _trainers(_cfg(aggr, PPR))
    want = j_complexity(jtr, num_roots_budget=64)
    got = t_complexity(ttr, num_roots_budget=64)
    np.testing.assert_allclose(got[VALID], want[J_VALID], rtol=1e-6)
    assert got[VALID] > 0


@pytest.mark.parametrize("smoothen", ["sym-2-concat", "rw-1-last",
                                      "ppr--sum-0.8-sym-none"])
def test_subgraph_preprocessing_matches_jax(smoothen):
    """A ``ppr`` preprocess sampler (k 8): the port's trainer smooths its
    features inside each mode's sampled subgraphs; JAX's
    ``smooth_signal_subgraph`` on the same graph writes the same rows,
    and the 40 nodes cut from TEST stay zero."""
    g = t_make(**GRAPH)
    g.node_set[2] = np.asarray(g.node_set[2])[:-40]
    cfg = _cfg("sage", [{"method": "ppr", "phase": "preprocess", "k": [8],
                         "epsilon": [1e-5]}] + PPR, smoothen)
    tr = Trainer("toy", "", g, t_parse(cfg), seed=0, device="cpu")
    fake = dataclasses.make_dataclass(
        "T", ["task", "batch_size", "num_nodes", "_host_adj", "entity_set"])(
        "node", 32, 600, {m: g.adj(m) for m in (0, 1, 2)}, g.node_set)
    want = jpre.smooth_signal_subgraph(
        fake, g.feat_full.astype(np.float32), *jpre.decode_smoothen_config(smoothen),
        {"method": "ppr", "k": 8, "epsilon": 1e-5})
    np.testing.assert_allclose(tr.feat_np, want, rtol=1e-4, atol=1e-5)
    covered = np.zeros(600, bool)
    for m in (0, 1, 2):
        covered[np.asarray(g.node_set[m])] = True
    assert (~covered).sum() == 40 and not tr.feat_np[~covered].any()
    assert (np.abs(tr.feat_np[covered]).sum(1) > 0).mean() > 0.9
    assert tr.dim_feat_smooth == want.shape[1] and tr.preproc_log[
        "feature_smoothen_steps"] >= 1


def _cli(tmp, *flags):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "shadow_gnn_torch.main", "--dataset", "toy",
         "--data_dir", str(tmp / "data"), "--log_dir", str(tmp / "logs"),
         "--device", "cpu", "--seed", "1", *flags],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return [ln for ln in r.stdout.splitlines() if ln.startswith("FINAL SUMMARY")][-1]


def test_cli_fused_gat_off_matches_auto(tmp_path):
    """``--fused_gat off`` is accepted and, like ``auto``, runs the one
    attention implementation of the port: the same final stats."""
    g = t_make(num_nodes=300, avg_deg=6, num_feat=8, num_classes=4, seed=1)
    save_shadow_format(str(tmp_path / "data"), "toy", indptr=g.indptr_full,
                       indices=g.indices_full, feat=g.feat_full,
                       label=g.label_full, node_set=g.node_set)
    cfg = _cfg("gat", [{"method": "ppr", "phase": "train", "k": [8],
                        "epsilon": [1e-5]}], dim=8, act="prelu")
    cfg["hyperparameter"].update(end=2, dropout=0.1)
    with open(tmp_path / "gat.yml", "w") as f:
        yaml.dump(cfg, f)
    lines = [_cli(tmp_path, "--configs", str(tmp_path / "gat.yml"), "--fused_gat",
                  v) for v in ("off", "auto")]
    assert lines[0] == lines[1]
    assert re.search(r"test: loss=[0-9.]+, accuracy=[0-9.]+", lines[0])
