"""PyTorch port, the first-epoch subgraph profile (``train/profiler.py``,
``Trainer._profile_epoch``) against the JAX package.

The statistics (hop composition, nodes, edges, subgraphs per branch) of
both profilers over the same batches, and of both Trainers' profile
passes over their first TRAIN epoch (node task cached and packed, link
task) must be equal, and so must the port's pass through its static step,
replayed from stub graphs, and the eager walk over ``_batches``.  With
both Trainers at their defaults (profile on)
a 2-epoch ``train()`` must draw the same epoch permutations and seeds
from ``rng_np``; the pass launches no kernel and the profiler is off
after the first epoch."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu import TRAIN as J_TRAIN
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.sampling.batch import SubgraphBatch as JBatch
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_tpu.train.profiler import SubgraphProfiler as JProfiler
from shadow_gnn_torch import TRAIN
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.ops.packed import packed_spmm
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.metrics import Metrics
from shadow_gnn_torch.train.pipeline import Trainer
from shadow_gnn_torch.train.profiler import SubgraphProfiler, batch_stats

torch.set_num_threads(2)
GRAPH = dict(num_nodes=500, avg_deg=8, num_feat=8, num_classes=4, seed=3)
LINK_GRAPH = dict(num_nodes=300, avg_deg=8.0, num_feat=8, seed=4, task="link")
CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 16, "aggr": "sage", "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 2, "lr": 1e-3, "dropout": 0.1, "dropedge": 0.0,
                       "batch_size": 32},
    "sampler": [{"method": "ppr", "phase": "train", "k": [16], "epsilon": [1e-5]}],
}
LINK_CFG = {
    "data": {"to_undirected": True, "transductive": True},
    "architecture": {"dim": 16, "aggr": "sage", "loss": "sigmoid",
                     "num_layers": 2, "act": "elu", "feature_augment": "drnls",
                     "feature_augment_ops": "concat", "residue": "concat",
                     "pooling": "sort-8"},
    "hyperparameter": {"end": 1, "lr": 1e-3, "dropout": 0.0, "dropedge": 0.0,
                       "batch_size": 16,
                       "percent_per_epoch": {"train": 0.25, "valid": 1, "test": 1}},
    "sampler": [{"method": "ppr", "phase": "train", "k": [12],
                 "threshold": [0.01], "epsilon": [1e-5]}],
}


def _trainers(cfg, graph, jax_packed=False, torch_packed=False, link=False):
    m = JMetrics("toy", link, "hits20" if link else "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**graph), j_parse(cfg), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False,
                   packed_adj=jax_packed)
    ttr = Trainer("toy", "", t_make(**graph), t_parse(cfg),
                  Metrics("toy", link, "hits20" if link else "accuracy", 1),
                  seed=0, device="cpu", packed_adj=torch_packed)
    return jtr, ttr


def _stats(p):
    return (np.asarray(p.hop_comp), p.num_nodes, p.num_edges, p.num_subg)


def _to_jax(tb):
    """The JAX package's SubgraphBatch holding a port batch's arrays."""
    def j(a):
        return jnp.asarray(a.numpy())
    return JBatch(nodes=j(tb.nodes.int()), node_mask=j(tb.node_mask),
                  adj=j(tb.adj), targets=j(tb.targets.int()), size=j(tb.size.int()),
                  hop=j(tb.hop.int()), ppr=j(tb.ppr), drnl=j(tb.drnl.int()))


def test_update_batch_matches_jax():
    """Both profilers fed the same batches (the second one twice)."""
    ttr = Trainer("toy", "", t_make(**GRAPH), t_parse(CFG), seed=0, device="cpu")
    ttr._ensure_tables(TRAIN)
    _, roots, rows, _, _ = ttr._epoch_arrays(TRAIN)
    ours, theirs = SubgraphProfiler(1), JProfiler(1)
    for lo in (0, 32, 32):
        bs, _ = ttr._sample_branch_batches(
            TRAIN, torch.as_tensor(roots[lo:lo + 32]), torch.as_tensor(rows[lo:lo + 32]))
        theirs.update_batch([_to_jax(bs[0])])
        ours.update_batch(bs)
    for got, want in zip(_stats(ours), _stats(theirs)):
        np.testing.assert_array_equal(got, want)
    s_t, s_j = ours.summary(), theirs.summary()
    for key in s_j:
        np.testing.assert_allclose(s_t[key], s_j[key], rtol=1e-12)
    assert s_t["avg_edges"][0] > 0 and s_t["hop_composition"][0][1] > 0


@pytest.mark.parametrize("case", ["cached", "packed", "link"])
def test_profile_epoch_matches_jax(case, capsys):
    """One profile pass over the first TRAIN epoch on both Trainers.
    ``packed``: the port's packed model counts the edges from the bits,
    which JAX's dense (unpacked) path counts from its blocks."""
    link = case == "link"
    jtr, ttr = _trainers(LINK_CFG if link else CFG, LINK_GRAPH if link else GRAPH,
                         torch_packed=case == "packed", link=link)
    for tr, mode in ((jtr, J_TRAIN), (ttr, TRAIN)):
        tr._ensure_tables(mode)
        tr._ensure_caches(mode)
    jtr._profile_epoch(J_TRAIN)

    def no_model(*args, **kw):
        raise AssertionError("the profile pass ran the model")

    ttr.model.forward = no_model
    calls = packed_spmm.calls
    ttr._profile_epoch(TRAIN)
    assert packed_spmm.calls == calls
    got, want = _stats(ttr.profiler), _stats(jtr.profiler)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    n_sub = ttr.profiler.num_subg[0]
    assert n_sub == (len(ttr.entity_set[TRAIN]) if not link else
                     int(np.ceil(0.25 * 2 * ttr.entity_set[TRAIN]["pos"].shape[0])))
    ttr.profiler.print_summary()
    out = capsys.readouterr().out
    assert "avg nodes" in out and "1-hop=" in out


def _eager_walk(tr, mode):
    """The profile pass as the eager ``_batches`` walk: each batch's
    ``batch_stats`` read and added on the host (the epoch drawn from
    ``rng_np`` as the pass draws it)."""
    nb, roots, rows, _, w = tr._epoch_arrays(mode)
    valid = torch.as_tensor(w > 0)
    prof = SubgraphProfiler(tr.num_ensemble)
    with torch.no_grad():
        for sl, batches, _ in tr._batches(mode, nb, roots, rows,
                                          torch.Generator().manual_seed(0)):
            for i, b in enumerate(batches):
                hops, nodes, edges, n = batch_stats(b, valid[sl])
                prof.update_stats(i, hops.numpy(), nodes.item(), edges.item(), n.item())
    return nb, _stats(prof)


@pytest.mark.parametrize("case", ["cached", "packed", "link"])
def test_graphed_profile_matches_the_eager_walk(case):
    """The profile's static step (``Trainer._static_profile``) through stub
    graphs that do what CUDA graphs do, replayed for every batch but the
    first, against the eager ``_batches`` walk of the same epoch and
    JAX's pass."""
    from test_torch_partition_graphs import stub_graphs
    link = case == "link"
    jtr, ttr = _trainers(LINK_CFG if link else CFG, LINK_GRAPH if link else GRAPH,
                         torch_packed=case == "packed", link=link)
    for tr, mode in ((jtr, J_TRAIN), (ttr, TRAIN)):
        tr._ensure_tables(mode)
        tr._ensure_caches(mode)
    jtr._profile_epoch(J_TRAIN)
    stub_graphs(ttr)
    # the walk draws the pass's epoch again (and the link task's negatives)
    rngs = (ttr.rng_np, ttr._neg_rng)
    states = [copy.deepcopy(r.bit_generator.state) for r in rngs]
    ttr._profile_epoch(TRAIN)
    for r, st in zip(rngs, states):
        r.bit_generator.state = st
    nb, walk = _eager_walk(ttr, TRAIN)
    for got, eager, want in zip(_stats(ttr.profiler), walk, _stats(jtr.profiler)):
        np.testing.assert_array_equal(got, eager)
        np.testing.assert_array_equal(got, want)
    key = ("profile", TRAIN, ttr.batch_size, ttr._cache_sig(TRAIN))
    assert dict(ttr.step_graphs.replays) == {key: nb - 1} and nb > 2


def test_jax_packed_path_counts_no_edges():
    """JAX's packed path gathers a placeholder block, so its profile
    counts 0 edges; the port's packed profile counts the bits."""
    jtr, ttr = _trainers(CFG, GRAPH, jax_packed=True, torch_packed=True)
    for tr, mode in ((jtr, J_TRAIN), (ttr, TRAIN)):
        tr._ensure_tables(mode)
        tr._ensure_caches(mode)
        tr._profile_epoch(mode)
    assert jtr.profiler.num_edges[0] == 0.0 and ttr.profiler.num_edges[0] > 0
    assert jtr.profiler.num_nodes[0] == ttr.profiler.num_nodes[0]
    np.testing.assert_array_equal(jtr.profiler.hop_comp[0], ttr.profiler.hop_comp[0])


class _Draws:
    """rng_np with every permutation and integer it draws recorded."""

    def __init__(self, gen):
        self.gen, self.log = gen, []

    def permutation(self, n):
        p = self.gen.permutation(n)
        self.log.append(p)
        return p

    def integers(self, *args, **kw):
        v = self.gen.integers(*args, **kw)
        self.log.append(int(v))
        return v


def test_default_runs_draw_jax_epoch_orders():
    """Both Trainers at their defaults (the first-epoch profile on), 2
    epochs of ``train()``: the same permutations and seeds, in the same
    order; each profiled its first TRAIN epoch once and then stopped."""
    jtr, ttr = _trainers(CFG, GRAPH, jax_packed=True, torch_packed=True)
    assert jtr.profiler.enabled and ttr.profiler.enabled
    jtr.rng_np, ttr.rng_np = _Draws(jtr.rng_np), _Draws(ttr.rng_np)
    jtr.train()
    ttr.train()
    j_log, t_log = jtr.rng_np.log, ttr.rng_np.log
    # the profile's permutation, then per epoch TRAIN and VALID (a
    # permutation and a seed each), then the final TRAIN, VALID, TEST
    assert len(t_log) == len(j_log) == 1 + 2 * 2 * 2 + 3 * 2
    for got, want in zip(t_log, j_log):
        np.testing.assert_array_equal(got, want)
    assert not ttr.profiler.enabled and not jtr.profiler.enabled
    assert ttr.profiler.num_subg == [0]
