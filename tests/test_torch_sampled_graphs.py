"""PyTorch port, the compiled sampled step.

The steps as functions of static buffers (``Trainer._static_train``,
``_static_eval``, ``_static_serve``) sample and induce every branch that
has no cache.  Replayed through stub graphs that do what a CUDA graph
does (a capture runs nothing; a replay runs the step and writes its
outputs into the captured ones; the dropout and sampler generators are
the registered ones, lent each pass), they equal the eager sampled steps
(``_batches`` + ``_train_step`` / ``_eval_step``, and a request sampled
with a generator seeded with ``SERVE_SEED``) bit for bit: per-batch
losses, predictions, the overflow, the final parameters and Adam state,
and served probabilities and embeddings.  Three models: the flagship
kind with its TRAIN cache disabled, a PPR + khop ensemble (PPR cached,
khop sampled in one step), and the link task's ``ppr_st`` + DRNL step.

Sampling and induction read no device value on the host (no
``_local_scalar_dense``) under every strategy and sampler, with the BFS
in a fixed number of levels standing in for the kernel.  The overflow is
a 0-d int64 tensor equal to JAX's on a ``cand`` plan that overflows and
on a hub plan with more hubs than slots, and an epoch reads it once.
``bfs_hops``, ``bfs_hops_multi`` and ``drnl_labels`` equal JAX's
exactly on a chain of N nodes (N - 1 levels), a disconnected block and
padding rows; ``ops/bfs.py`` refuses an N above its limit by name."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.data.graph import DeviceGraph as JGraph
from shadow_gnn_tpu.data.synthetic import make_random_graph
from shadow_gnn_tpu.sampling import induction as jind
from shadow_gnn_tpu.sampling.batch import SamplerConfig as JCfg
from shadow_gnn_torch import TEST, TRAIN, VALID
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.data.graph import DeviceGraph as TGraph
from shadow_gnn_torch.nn.model import predict_fn
from shadow_gnn_torch.ops import bfs
from shadow_gnn_torch.sampling import induction as tind
from shadow_gnn_torch.sampling.batch import SamplerConfig, total_overflow
from shadow_gnn_torch.sampling.samplers import PPRTables, sample_subgraphs
from shadow_gnn_torch.train.config import parse_config
from shadow_gnn_torch.train.metrics import Metrics
from shadow_gnn_torch.train.pipeline import SERVE_SEED, EpochRNG, Trainer
from test_torch_partition_graphs import _NoHostReads, _bfs_levels
from test_torch_partition_graphs import stub_graphs as _stub_graphs

torch.set_num_threads(2)
_HYPER = {"end": 1, "lr": 1e-3, "dropout": 0.2, "dropedge": 0.1, "batch_size": 16}
MODELS = {
    # the flagship's kind: SAGE, hop augment, PPR, its TRAIN cache disabled
    "flagship": (dict(num_nodes=400, avg_deg=8, num_feat=8, num_classes=4, seed=3), {
        "data": {"to_undirected": False, "transductive": True},
        "architecture": {"dim": 16, "aggr": "sage", "loss": "softmax",
                         "num_layers": 2, "act": "relu", "feature_augment": "hops",
                         "residue": "none", "pooling": "center"},
        "hyperparameter": _HYPER,
        "sampler": [{"method": "ppr", "phase": "train", "k": [12],
                     "epsilon": [1e-5]}]}),
    # the arxiv ensemble's kind: GAT, a cached PPR and a sampled khop branch
    "ensemble": (dict(num_nodes=500, avg_deg=10.0, num_feat=8, num_classes=4, seed=3,
                      power_law=True), {
        "data": {"to_undirected": True, "transductive": True},
        "architecture": {"dim": 16, "aggr": "gat", "heads": 2, "loss": "softmax",
                         "num_layers": 2, "act": "relu", "feature_augment": "hops",
                         "residue": "sum", "pooling": "mean",
                         "ensemble_act": "leakyrelu"},
        "hyperparameter": dict(_HYPER, ensemble_dropout="none"),
        "sampler": [{"method": "ppr", "phase": "train", "k": [12], "epsilon": [1e-5]},
                    {"method": "khop", "phase": "train", "depth": [2],
                     "budget": [3]}]}),
    # the collab link model's kind: ppr_st, DRNL one-hots, sort pooling
    "link": (dict(num_nodes=300, avg_deg=8.0, num_feat=8, seed=4, task="link"), {
        "data": {"to_undirected": True, "transductive": True},
        "architecture": {"dim": 16, "aggr": "sage", "loss": "sigmoid",
                         "num_layers": 2, "act": "elu", "feature_augment": "drnls",
                         "feature_augment_ops": "concat", "residue": "concat",
                         "pooling": "sort-8"},
        "hyperparameter": dict(_HYPER, percent_per_epoch={"train": 0.25, "valid": 1,
                                                          "test": 1}),
        "sampler": [{"method": "ppr_st", "phase": "train", "k": [12],
                     "threshold": [0.01], "epsilon": [1e-5]}]}),
}


def _trainer(kind):
    graph, cfg = MODELS[kind]
    metrics = Metrics("toy", True, "hits20", 1) if kind == "link" else None
    tr = Trainer("toy", "", t_make(**graph), parse_config(cfg), metrics, seed=0,
                 device="cpu", packed_adj=kind == "flagship")
    tr.profiler.enabled = False
    return tr


def _eager_pass(tr, mode, train, nb, roots, rows, labels, w, rng):
    """The eager sampled pass: each batch from ``_batches``, then
    ``_train_step`` or ``_eval_step``; the overflow summed."""
    lab = torch.as_tensor(labels.astype(np.float32 if labels.ndim > 1 else np.int64))
    w_t = torch.as_tensor(w)
    tr.model.train(train)
    losses, preds, ovf = [], [], 0
    for sl, batches, feats in tr._batches(mode, nb, roots, rows, rng.sample):
        ovf += int(total_overflow(batches, tr.device))
        if train:
            loss, pred = tr._train_step(batches, feats, lab[sl], w_t[sl], rng)
        else:
            loss, pred = tr._eval_step(batches, feats, lab[sl], w_t[sl],
                                       mode_train=mode == TRAIN)
        losses.append(loss)
        preds.append(pred)
    tr.model.eval()
    return torch.stack(losses).numpy(), torch.cat(preds).numpy(), ovf


def _eager_serve(tr, ids, mode=TEST):
    """The eager sampled request: every branch sampled (or gathered) with
    a generator seeded with ``SERVE_SEED``, padded to the request bucket."""
    tr._ensure_tables(mode)
    tr._ensure_caches(mode)
    rows = tr._serve_lookup(mode)[ids]
    n, cap = ids.size, 8 if ids.size <= 8 else tind.bucket_cap(ids.size)
    ids = np.concatenate([ids, np.full(cap - n, ids[0])])
    rows = np.concatenate([rows, np.full(cap - n, rows[0])])
    with torch.no_grad():
        batches, feats = tr._sample_branch_batches(
            mode, torch.as_tensor(ids[:, None]), torch.as_tensor(rows[:, None]),
            torch.Generator().manual_seed(SERVE_SEED))
        logits, embs = tr.model(batches, feats)
    return predict_fn(tr.model_cfg, logits)[:n].numpy(), torch.stack(embs)[:, :n].numpy()


@pytest.mark.parametrize("kind", list(MODELS))
def test_graphed_sampled_steps_equal_eager(kind):
    """Two TRAIN passes and a VALID pass through the stub-graphed steps
    against the eager sampled passes of a twin, then requests."""
    graphed, eager = _trainer(kind), _trainer(kind)
    _stub_graphs(graphed)
    if kind == "flagship":
        for tr in (graphed, eager):
            tr.disable_cache(TRAIN)
    b = graphed.batch_size
    for mode, train in ((TRAIN, True), (TRAIN, True), (VALID, False)):
        out = []
        for tr in (graphed, eager):
            tr._ensure_tables(mode)
            tr._ensure_caches(mode)
            nb, roots, rows, labels, w = tr._epoch_arrays(mode)
            rng = EpochRNG.from_seed(int(tr.rng_np.integers(1 << 31)), tr.device)
            if tr is graphed:
                losses, preds, ovf = tr._run_batches(mode, train, nb, roots, rows,
                                                     labels, w, rng)
                assert ovf.dim() == 0 and ovf.dtype == torch.int64
                out.append((losses, preds, int(ovf)))
            else:
                out.append(_eager_pass(tr, mode, train, nb, roots, rows, labels, w,
                                       rng))
        for got, want in zip(*out):
            np.testing.assert_array_equal(got, want)
    sig = graphed._cache_sig(TRAIN)
    assert "sampled" in sig and graphed._cache_sig(VALID) == (
        ("cached", "sampled") if kind == "ensemble" else
        ("cached",) if kind == "flagship" else ("sampled",))
    sg = graphed.step_graphs
    nb_train = -(-int(np.ceil(0.25 * 2 * len(graphed.entity_set[TRAIN]["pos"])))
                 // b) if kind == "link" else -(-len(graphed.entity_set[TRAIN]) // b)
    assert sg.replays[("train", TRAIN, b, sig)] == 2 * nb_train - 1
    assert {k[0] for k in sg.graphs} == {"train", "eval"}
    sd_g, sd_e = graphed.model.state_dict(), eager.model.state_dict()
    assert all(torch.equal(sd_g[k], sd_e[k]) for k in sd_e)
    o_g, o_e = (t.optimizer.state_dict()["state"] for t in (graphed, eager))
    assert o_g.keys() == o_e.keys() and all(
        torch.equal(o_g[k][n], o_e[k][n]) for k in o_e for n in o_e[k])
    if kind == "link":
        return
    # the flagship's TEST sampled, the ensemble's PPR branch gathered and
    # its khop branch sampled in one request
    rng = np.random.default_rng(1)
    test_ids = np.asarray(graphed.entity_set[TEST])
    if kind == "flagship":
        graphed.disable_cache(TEST)
        eager.disable_cache(TEST)
    for size in (1, 5, 20, 20):
        ids = rng.choice(test_ids, size, replace=False)
        got = graphed.predict_nodes(ids), graphed.embed_nodes(ids)
        want = _eager_serve(eager, ids)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(np.stack(got[1]), want[1])
    serve_sig = graphed._cache_sig(TEST)
    assert "sampled" in serve_sig
    assert sg.replays[("serve", TEST, 8, serve_sig)] == 3
    assert sg.replays[("serve", TEST, 64, serve_sig)] == 3


def test_disable_cache_keeps_the_mode_graphed():
    """A mode's cached keys go with its cache; the mode then replays its
    sampled keys."""
    tr = _trainer("flagship")
    _stub_graphs(tr)
    tr.run_epoch(0, TRAIN)
    cached = ("train", TRAIN, tr.batch_size, ("cached",))
    assert tr.step_graphs.replays[cached] > 0 and cached in tr.step_graphs.graphs
    tr.disable_cache(TRAIN)
    assert cached not in tr.step_graphs.graphs
    tr.run_epoch(1, TRAIN)
    assert tr.step_graphs.replays[("train", TRAIN, tr.batch_size, ("sampled",))] > 0
    assert "TRAIN and eval steps and the serving buckets replay" in Trainer._graph_plan(
        tr)


# ---------------------------------------------------------------------------
# no host reads inside sampling and induction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,fields", [
    ("ppr", dict(induction="rows", deg_cap=64, hub_slots=0)),
    ("ppr", dict(induction="rows", deg_cap=16, hub_slots=3)),
    ("ppr", dict(induction="hub", cand_cap=256, deg_cap=16, hub_slots=3)),
    ("ppr", dict(induction="cand", cand_cap=128)),
    ("ppr", dict(induction="search")),
    ("ppr_st", dict(induction="rows", deg_cap=64, num_targets=2, aug_feats=("drnls",))),
    ("khop", dict(induction="rows", deg_cap=16, hub_slots=3)),
    ("nodeIID", dict(induction="search")),
])
def test_sampling_reads_nothing_on_the_host(monkeypatch, method, fields):
    fields = dict(fields)
    indptr, indices = make_random_graph(300, 10.0, seed=2, power_law=True)
    g = TGraph.from_csr(indptr, indices)
    rng = np.random.default_rng(0)
    nt = fields.get("num_targets", 1)
    roots = torch.as_tensor(rng.choice(300, (8, nt), replace=False))
    k = 12
    tab_n = torch.as_tensor(rng.integers(-1, 300, (300, 2 * k)))
    tab_s = torch.where(tab_n >= 0, torch.as_tensor(rng.random((300, 2 * k)),
                                                    dtype=torch.float32), 0.0)
    aug = fields.pop("aug_feats", ("hops",))
    cfg = SamplerConfig(method=method, n_pad=16 if method == "khop" else nt * (k + 1),
                        k=k, depth=2, budget=3, add_self_edge=True, aug_feats=aug,
                        **fields)
    tables = PPRTables(tab_n, tab_s)
    want = sample_subgraphs(cfg, g, roots, roots, tables, torch.Generator().manual_seed(1))
    monkeypatch.setattr(tind, "bfs_hops_multi", _bfs_levels)
    with _NoHostReads():
        got = sample_subgraphs(cfg, g, roots, roots, tables,
                               torch.Generator().manual_seed(1))
    for f in ("nodes", "adj", "targets", "hop", "drnl", "overflow"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.overflow.dim() == 0 and got.overflow.dtype == torch.int64


# ---------------------------------------------------------------------------
# the overflow as a device tensor, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hub_case():
    indptr, indices = make_random_graph(800, 12.0, seed=5, power_law=True)
    rng = np.random.default_rng(0)
    nodes = np.full((12, 48), 800, np.int32)
    for b in range(12):
        pool = np.r_[np.arange(20), rng.choice(800, 100, replace=False)]
        picks = np.unique(rng.choice(pool, rng.integers(5, 49)))
        nodes[b, :picks.size] = picks
    return (JGraph.from_csr(indptr, indices), TGraph.from_csr(indptr, indices),
            jnp.asarray(nodes), torch.as_tensor(nodes.astype(np.int64)))


@pytest.mark.parametrize("plan", ["cand", "hub", "rows"])
def test_overflow_tensor_matches_jax(hub_case, plan):
    """A ``cand`` plan under its candidates, a hub plan and a rows plan
    with more hubs than slots: the same overflow as JAX's, as a 0-d int64
    tensor."""
    jg, tg, nj, nt = hub_case
    if plan == "cand":
        (ja, jo), (ta, to) = (jind.membership_matrix_cand(jg, nj, 300),
                              tind.membership_matrix_cand(tg, nt, 300))
    elif plan == "hub":
        (ja, jo), (ta, to) = (jind.membership_matrix_hub(jg, nj, 4096, 64, 1),
                              tind.membership_matrix_hub(tg, nt, 4096, 64, 1))
    else:
        (ja, jo), (ta, to) = (jind.membership_matrix_rows(jg, nj, 64, 1),
                              tind.membership_matrix_rows(tg, nt, 64, 1))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert to.dim() == 0 and to.dtype == torch.int64
    assert int(to) == int(jo) > 0


def test_epoch_reads_the_overflow_once(capsys):
    """A sampled TRAIN epoch under an overflowing ``cand`` plan: one
    warning, with the sum of the eager batches' overflows."""
    trs = [_trainer("flagship") for _ in range(2)]
    for tr in trs:
        tr._ensure_tables(TRAIN)
        br = tr.branches[0]
        br["cfg"][TRAIN] = dataclasses.replace(br["cfg"][TRAIN], induction="cand",
                                               cand_cap=24)
        tr.nocache_modes.add(TRAIN)
    nb, roots, rows, labels, w = trs[1]._epoch_arrays(TRAIN)
    seed = int(trs[1].rng_np.integers(1 << 31))
    *_, want = _eager_pass(trs[1], TRAIN, True, nb, roots, rows, labels, w,
                           EpochRNG.from_seed(seed, trs[1].device))
    trs[0].run_epoch(0, TRAIN)
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("[WARN] induction candidate overflow")]
    assert want > 0 and lines == [f"[WARN] induction candidate overflow: {want} edges "
                                  "dropped this epoch (raise cand_cap)"]


# ---------------------------------------------------------------------------
# the BFS: plain version against JAX, the kernel's refusals
# ---------------------------------------------------------------------------

def _bfs_blocks(n=40):
    """[5, n, n] blocks: a chain (n - 1 levels from node 0), two
    disconnected components, a block whose last 10 rows are padding
    (connected in the block but masked), a random sparse block, and a
    block whose frontier rows cancel (``_cancelling_block``); self edges
    on every valid node."""
    rng = np.random.default_rng(3)
    adj = np.zeros((5, n, n), np.float32)
    i = np.arange(n - 1)
    adj[0, i, i + 1] = adj[0, i + 1, i] = 1
    half = n // 2
    adj[1, :half, :half] = rng.random((half, half)) < 0.2
    adj[1, half:, half:] = rng.random((n - half, n - half)) < 0.2
    adj[2] = rng.random((n, n)) < 0.1
    adj[3] = rng.random((n, n)) < 0.05
    adj[4] = _cancelling_block(n)
    mask = np.ones((5, n), bool)
    mask[2, n - 10:] = False
    adj[2, n - 10:] = 0
    for b in range(5):
        adj[b][np.diag(mask[b])] = 1
    starts = np.array([[0, n - 1], [1, half + 2], [3, n - 5], [7, n], [0, 1]], np.int64)
    return adj, starts, mask


def _cancelling_block(n):
    """A block where a sum over the frontier rows and "any entry > 0"
    disagree.  From node 0: level 1 is {1, 2}; there row 1 holds +1 and row
    2 -1 on the columns 3 .. n/2 (sum 0), and row 1 -3 beside row 2's +1 on
    column n - 1 (sum -2), so level 2 is n/2 + 1 .. n - 2 only; row n - 2
    reaches 3 and n - 1 (level 3), row 3 the columns 4 .. n/2 (level 4)."""
    half = n // 2
    adj = np.zeros((n, n), np.float32)
    adj[0, 1:3] = 1
    adj[1, 3:] = 1
    adj[1, n - 1] = -3
    adj[2, 3:half + 1] = -1
    adj[2, n - 1] = 1
    adj[n - 2, [3, n - 1]] = 1
    adj[3, 4:half + 1] = 1
    return adj


def _cancelling_levels(n):
    """The BFS levels of ``_cancelling_block`` from node 0."""
    half = n // 2
    want = np.full(n, -1)
    want[0] = 0
    want[1:3] = 1
    want[half + 1:n - 1] = 2
    want[[3, n - 1]] = 3
    want[4:half + 1] = 4
    return want


def test_bfs_matches_jax():
    adj, starts, mask = _bfs_blocks()
    ja, jm = jnp.asarray(adj), jnp.asarray(mask)
    ta, tm = torch.as_tensor(adj), torch.as_tensor(mask)
    ts = torch.as_tensor(starts)
    multi = tind.bfs_hops_multi(ta, ts, tm)
    np.testing.assert_array_equal(
        multi.numpy(), np.asarray(jind.bfs_hops_multi(ja, jnp.asarray(starts), jm)))
    assert torch.equal(multi, bfs.bfs_hops_plain(ta, ts, tm))
    assert torch.equal(multi, _bfs_levels(ta, ts, tm))
    np.testing.assert_array_equal(
        tind.bfs_hops(ta, ts[:, 0], tm).numpy(),
        np.asarray(jind.bfs_hops(ja, jnp.asarray(starts[:, 0]), jm)))
    np.testing.assert_array_equal(
        tind.drnl_labels(ta, ts, tm).numpy(),
        np.asarray(jind.drnl_labels(ja, jnp.asarray(starts), jm)))
    n = adj.shape[1]
    assert multi[0, 0].max() == n - 1                      # the chain
    assert (multi[1, 0, n // 2:] == -1).all()              # the other component
    assert (multi[2, 0, n - 10:] == -1).all()              # padding
    # a start on padding: 0 there, nothing reached beyond it
    assert multi[2, 1, n - 5] == 0 and (multi[2, 1] == -1).sum() == n - 1
    assert (multi[3, 1] == -1).all()                       # a start beyond N
    # the sum over the frontier rows, not "any entry > 0"
    np.testing.assert_array_equal(multi[4, 0].numpy(), _cancelling_levels(n))
    assert multi.dtype == torch.int64


@pytest.mark.parametrize("n", [37, 38, 39])
def test_bfs_matches_jax_n_not_a_multiple_of_4(n):
    """The blocks of ``test_bfs_matches_jax`` at N % 4 != 0 (the kernel's
    rows then lose their 16-byte alignment): the plain BFS, the CPU
    ``bfs_hops_multi`` and DRNL equal JAX's exactly."""
    adj, starts, mask = _bfs_blocks(n)
    ja, jm, js = jnp.asarray(adj), jnp.asarray(mask), jnp.asarray(starts)
    ta, tm, ts = torch.as_tensor(adj), torch.as_tensor(mask), torch.as_tensor(starts)
    want = np.asarray(jind.bfs_hops_multi(ja, js, jm))
    np.testing.assert_array_equal(bfs.bfs_hops_plain(ta, ts, tm).numpy(), want)
    np.testing.assert_array_equal(tind.bfs_hops_multi(ta, ts, tm).numpy(), want)
    np.testing.assert_array_equal(tind.drnl_labels(ta, ts, tm).numpy(),
                                  np.asarray(jind.drnl_labels(ja, js, jm)))
    assert want[0, 0].max() == n - 1
    np.testing.assert_array_equal(want[4, 0], _cancelling_levels(n))


@pytest.mark.parametrize("self_edge", [False, True])
def test_bfs_link_block_with_a_repeated_target(self_edge):
    """A link batch induced by both packages where a pair repeats its node
    (``t_any`` 2 there: the block holds -3 at that node's self loop unless
    self edges are added): the blocks, the DRNL labels and the BFS from
    both targets equal JAX's exactly."""
    rng = np.random.default_rng(5)
    nn = 24
    dense = rng.random((nn, nn)) < 0.15
    dense = dense | dense.T
    np.fill_diagonal(dense, False)
    dense[[5, 9], [5, 9]] = True                           # self loops
    indptr = np.r_[0, np.cumsum(dense.sum(1))].astype(np.int64)
    indices = np.nonzero(dense)[1].astype(np.int64)
    nodes = np.full((3, 16), nn, np.int64)
    for b, picks in enumerate(([0, 2, 5, 7, 9, 11, 13, 17, 20],
                               [1, 5, 6, 9, 12, 14, 15, 18, 19, 22, 23],
                               [3, 4, 8, 9, 10, 16, 21])):
        nodes[b, :len(picks)] = picks
    roots = np.array([[5, 5], [5, 9], [9, 9]], np.int64)
    ppr = np.zeros(nodes.shape, np.float32)
    kw = dict(method="ppr_st", n_pad=16, num_targets=2, add_self_edge=self_edge,
              aug_feats=("drnls",))
    want = jind.induce(JGraph.from_csr(indptr, indices), jnp.asarray(nodes),
                       jnp.asarray(ppr), jnp.asarray(roots), JCfg(**kw))
    got = tind.induce(TGraph.from_csr(indptr, indices), torch.as_tensor(nodes),
                      torch.as_tensor(ppr), torch.as_tensor(roots), SamplerConfig(**kw))
    np.testing.assert_array_equal(got.adj.numpy(), np.asarray(want.adj))
    np.testing.assert_array_equal(got.drnl.numpy(), np.asarray(want.drnl))
    assert (got.adj.min() == -3) != self_edge              # the repeated self loop
    targets = got.targets[:, :2]
    np.testing.assert_array_equal(
        bfs.bfs_hops_plain(got.adj, targets, got.node_mask).numpy(),
        np.asarray(jind.bfs_hops_multi(want.adj, want.targets[:, :2],
                                       want.node_mask)))


def test_bfs_kernel_refusals():
    """The kernel's limit by name, and no CPU fallback for a tensor that
    is not on the CPU."""
    big = bfs.MAX_N + 1
    meta = dict(device="meta")
    with pytest.raises(ValueError, match=f"N={big} above the kernel's limit MAX_N"):
        bfs.check_shapes(torch.empty(2, big, big, **meta),
                         torch.empty(2, 1, dtype=torch.int64, **meta),
                         torch.empty(2, big, dtype=torch.bool, **meta))
    with pytest.raises(TypeError):
        bfs.check_shapes(torch.empty(2, 8, 8, dtype=torch.float64),
                         torch.zeros(2, 1, dtype=torch.int64),
                         torch.ones(2, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="one CUDA device"):
        bfs.bfs_hops_multi(torch.empty(2, 8, 8, **meta),
                           torch.empty(2, 1, dtype=torch.int64, **meta),
                           torch.empty(2, 8, dtype=torch.bool, **meta))
    assert bfs.bfs_hops_multi.launches == 0
    # the limit itself is taken, and its launch fits one block's shared memory
    bfs.check_shapes(torch.empty(1, bfs.MAX_N, bfs.MAX_N, **meta),
                     torch.empty(1, 2, dtype=torch.int64, **meta),
                     torch.empty(1, bfs.MAX_N, dtype=torch.bool, **meta))
    for b in (1, 1000):
        assert bfs.launch_dims(b, bfs.MAX_N, 1, 132).smem <= bfs.MAX_SMEM


@pytest.mark.parametrize("b, n, s, sms, cluster", [
    (64, 208, 1, 132, 1),       # the cold step's hops: one CTA beats a cluster
    (16, 408, 2, 132, 4),       # the link task's DRNL: 128 CTAs
    (4, 907, 2, 132, 8),
    (1, bfs.MAX_N, 1, 132, 8),
    (4, 255, 1, 132, 1),        # below CLUSTER_MIN_N
    (4, 256, 1, 132, 8),
    (33, 408, 2, 132, 2),       # 132 CTAs
    (66, 408, 2, 132, 1),       # B * S above the SM count
    (16, 408, 2, 114, 2),       # a card of fewer SMs
    (200, bfs.MAX_N, 1, 132, 1),
])
def test_bfs_launch_dims(b, n, s, sms, cluster):
    """One cluster per (subgraph, source) from N = CLUSTER_MIN_N up, of
    the largest size of 8, 4, 2 whose B * S clusters take one CTA an SM,
    else one CTA; a CTA owns every size-th 4-column group."""
    d = bfs.launch_dims(b, n, s, sms)
    assert d.cluster == cluster and d.grid == b * s * cluster
    assert d.threads == bfs.THREADS
    if cluster > 1:
        assert b * s * cluster <= sms and n >= bfs.CLUSTER_MIN_N
    if cluster < max(bfs.CLUSTERS):                         # the largest that fits
        assert b * s * 2 * cluster > sms or n < bfs.CLUSTER_MIN_N
    groups = -(-n // 4)
    assert d.width == 4 * -(-groups // cluster) and d.width * cluster >= n
    assert d == bfs.cluster_dims(b, n, s, cluster)
    assert d.smem == bfs.smem_bytes(d.width) <= bfs.MAX_SMEM
