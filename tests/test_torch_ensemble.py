"""PyTorch port: the ensemble — ``EnsembleAggregator`` and a two-branch
GAT ``DeepGNN`` (2 heads, dim 16, 2 layers, hop augment, sum residue,
mean pooling, as configs/arxiv_ensemble_ppr_khop.yml at test width)
against the JAX package's flax modules under the same weights
(``params_from_flax``): logits, embeddings, the loss and every gradient
at dropout 0, atol 1e-5 / rtol 1e-4.  Then a Trainer on a toy two-branch
(ppr + khop) config on the CPU: its khop plan equals the JAX Trainer's,
it trains an epoch, and serving answers the same ids the same way."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.nn import model as jmodel
from shadow_gnn_tpu.nn import respool as jrespool
from shadow_gnn_tpu.sampling.batch import SubgraphBatch as JBatch
from shadow_gnn_tpu.train import pipeline as jpipeline
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import weighted_loss_fn as j_wloss
from shadow_gnn_torch import TEST, TRAIN, VALID
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.nn import layers as tlayers
from shadow_gnn_torch.nn import model as tmodel
from shadow_gnn_torch.nn import respool as trespool
from shadow_gnn_torch.ops.gat import gat_attention
from shadow_gnn_torch.sampling.batch import SubgraphBatch as TBatch
from shadow_gnn_torch.train import pipeline as tpipeline
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import Trainer
from shadow_gnn_torch.train.pipeline import weighted_loss_fn as t_wloss

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
B, F, DIM, C = 4, 12, 16, 5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _perturbed(params, seed=4):
    """Parameters moved off their initial values (q at ones, norm scales
    1, offsets 0), so that each one matters."""
    return jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(seed), p.shape),
        params)


def _batch_arrays(n, seed):
    """A random padded [B, n] batch: sorted ids, symmetric 0/1 blocks with
    self edges over the valid rows, hops, and a feature block."""
    rng = np.random.default_rng(seed)
    sizes = np.array([n, n - 3, n // 2, n - 1])
    nodes = np.full((B, n), 1000, np.int32)
    mask = np.zeros((B, n), bool)
    adj = np.zeros((B, n, n), np.float32)
    for b, s in enumerate(sizes):
        nodes[b, :s] = np.sort(rng.choice(1000, s, replace=False))
        mask[b, :s] = True
        a = (rng.random((s, s)) < 0.25).astype(np.float32)
        adj[b, :s, :s] = np.maximum(np.maximum(a, a.T), np.eye(s))
    targets = np.array([[rng.integers(s)] for s in sizes], np.int32)
    hop = np.where(mask, rng.integers(-1, 5, (B, n)), -1).astype(np.int32)
    feat = rng.normal(size=(B, n, F)).astype(np.float32)
    return dict(nodes=nodes, node_mask=mask, adj=adj, targets=targets,
                size=sizes.astype(np.int32), hop=hop,
                ppr=np.zeros((B, n), np.float32),
                drnl=np.zeros((B, n), np.int32)), feat


def _jax_batch(a):
    return JBatch(**{k: jnp.asarray(v) for k, v in a.items()})


def _torch_batch(a):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    for k in ("nodes", "targets", "hop", "drnl", "size"):
        t[k] = t[k].long()
    return TBatch(**t)


@pytest.mark.parametrize("act", ["leakyrelu", "prelu"])
@pytest.mark.parametrize("type_dropout", ["none", "feat", "coef"])
def test_ensemble_aggregator_matches_jax(act, type_dropout):
    """Three branches' embeddings: the softmax-weighted sum, at dropout
    0 in training mode (every dropout kind is then the identity)."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(6, DIM)).astype(np.float32) for _ in range(3)]
    agg = jrespool.EnsembleAggregator(dim_hid=DIM, num_ensemble=3, act=act,
                                      type_dropout=type_dropout)
    params = _perturbed(agg.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs],
                                 train=False))
    want = agg.apply(params, [jnp.asarray(x) for x in xs], train=True)
    tagg = trespool.EnsembleAggregator(DIM, 0.0, act, type_dropout).train()
    sd = params_from_flax({"ensembler": _np_tree(params)["params"]})
    tagg.load_state_dict({k[len("ensembler."):]: v for k, v in sd.items()})
    got = tagg([torch.as_tensor(x) for x in xs], torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        trespool.EnsembleAggregator(DIM, type_dropout="both")


def _configs(branch_sharing):
    kw = dict(dim_feat_smooth=F, dim_label_raw=C, dim_label_smooth=0, aggr="gat",
              heads=2, num_layers=2, dim=DIM, act="relu", feature_augment=("hops",),
              residue="sum", pooling="mean", num_ensemble=2,
              branch_sharing=branch_sharing)
    return jmodel.ModelConfig(dim_feat_raw=F, **kw), tmodel.ModelConfig(**kw)


def _two_branch_case(branch_sharing):
    """The JAX model and its perturbed parameters, and two branches'
    batches of different widths (24 and 16 nodes)."""
    jcfg, tcfg = _configs(branch_sharing)
    arrays = [_batch_arrays(24, 3), _batch_arrays(16, 4)]
    jargs = ([_jax_batch(a) for a, _ in arrays], [jnp.asarray(f) for _, f in arrays])
    targs = ([_torch_batch(a) for a, _ in arrays],
             [torch.as_tensor(f) for _, f in arrays])
    jm = jmodel.DeepGNN(jcfg)
    params = _perturbed(jm.init({"params": jax.random.PRNGKey(1)}, *jargs,
                                mode_train=True, train=False))
    return jcfg, tcfg, jm, params, jargs, targs


@pytest.mark.parametrize("branch_sharing", [False, True])
def test_two_branch_forward_matches_jax(branch_sharing):
    jcfg, tcfg, jm, params, jargs, targs = _two_branch_case(branch_sharing)
    names = set(params["params"])
    assert {"ensembler", "res_pool_1", "aug_1_hops"} <= names
    assert ("conv_1_0" in names) != branch_sharing
    want_logits, want_emb = jm.apply(params, *jargs, mode_train=False, train=False)
    tm = tmodel.DeepGNN(tcfg).eval()
    tm.load_state_dict(params_from_flax(_np_tree(params)))
    with torch.no_grad():
        logits, emb = tm(*targs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    assert len(emb) == 2
    for e, w in zip(emb, want_emb):
        np.testing.assert_allclose(e.numpy(), np.asarray(w), **TOL)
    # the branches differ, so the aggregator's weights matter
    assert not np.allclose(emb[0].numpy(), emb[1].numpy(), atol=1e-3)


@pytest.mark.parametrize("branch_sharing", [False, True])
def test_two_branch_train_mode_matches_jax(branch_sharing):
    """train() mode at dropout 0: the loss and the gradient of every
    parameter equal flax apply(train=True)."""
    jcfg, tcfg, jm, params, jargs, targs = _two_branch_case(branch_sharing)
    labels = np.random.default_rng(2).integers(0, C, B)
    w = np.array([1, 1, 0, 1], np.float32)

    def lf(p):
        logits, _ = jm.apply(p, *jargs, mode_train=True, train=True)
        return j_wloss(jcfg, logits, jnp.asarray(labels), jnp.asarray(w)), logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(lf, has_aux=True)(params)
    tm = tmodel.DeepGNN(tcfg).train()
    tm.load_state_dict(params_from_flax(_np_tree(params)))
    logits, _ = tm(*targs, torch.Generator().manual_seed(0), 123)
    loss = t_wloss(tcfg, logits, torch.as_tensor(labels), torch.as_tensor(w))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(loss.item(), float(j_loss), **TOL)
    want = params_from_flax(_np_tree(j_grads))
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, **TOL)


def test_model_checks_its_branch_count():
    _, tcfg = _configs(False)
    a, f = _batch_arrays(24, 3)
    with pytest.raises(ValueError, match="2 branches"):
        tmodel.DeepGNN(tcfg)(_torch_batch(a), torch.as_tensor(f))
    with pytest.raises(ValueError):
        tmodel.DeepGNN(dataclasses.replace(tcfg, num_ensemble=0))


# configs/arxiv_ensemble_ppr_khop.yml at test size: ppr k=16 and khop
# depth 2 budget 4 (n_pad 24 each), GAT 2 heads dim 16, 2 layers
GRAPH = dict(num_nodes=800, avg_deg=12.0, num_feat=F, num_classes=C, seed=3,
             power_law=True)
ENS_CFG = {
    "data": {"to_undirected": True, "transductive": True},
    "architecture": {"dim": DIM, "aggr": "gat", "heads": 2, "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "sum", "pooling": "mean",
                     "ensemble_act": "leakyrelu"},
    "hyperparameter": {"end": 1, "lr": 1e-3, "dropout": 0.3, "dropedge": 0.05,
                       "batch_size": 16, "ensemble_dropout": "none"},
    "sampler": [{"method": "ppr", "phase": "train", "k": [16], "epsilon": [1e-5]},
                {"method": "khop", "phase": "train", "depth": [2], "budget": [4]}],
}


def _jax_trainer(graph, cfg):
    m = JMetrics("toy", False, "accuracy", 1)
    return jpipeline.Trainer("toy", "", graph, j_parse(cfg), m,
                             JLogger(m, "", no_log=True), seed=0,
                             use_device_ppr=False)


@pytest.fixture(scope="module")
def ens_trainers():
    return (_jax_trainer(j_make(**GRAPH), ENS_CFG),
            Trainer("toy", "", t_make(**GRAPH), t_parse(ENS_CFG), seed=0,
                    device="cpu"))


def _fields(tr, i, mode):
    return dataclasses.asdict(tr.branches[i]["cfg"][mode])


def test_ensemble_trainer_plans_match_jax(ens_trainers):
    """Both branches' SamplerConfigs in every mode (the khop branch from
    _build_branches, the ppr branch once its tables are planned); the
    model's ensemble fields."""
    jtr, ttr = ens_trainers
    for tr in (jtr, ttr):
        tr._ensure_tables(TEST)
    for i in (0, 1):
        for mode in (TRAIN, VALID, TEST):
            if i == 0 and mode != TEST:
                continue
            assert _fields(ttr, i, mode) == _fields(jtr, i, mode), (i, mode)
    khop = ttr.branches[1]["cfg"][TRAIN]
    assert (khop.method, khop.induction, khop.hub_slots, khop.n_pad) == (
        "khop", "rows", 8, 24)
    assert ttr.num_ensemble == 2 and ttr.tables[TEST][1] is None
    for f in ("num_ensemble", "branch_sharing", "ensemble_act", "ensemble_dropout"):
        assert getattr(ttr.model_cfg, f) == getattr(jtr.model_cfg, f), f


def test_ensemble_trainer_trains_and_serves(ens_trainers, monkeypatch):
    """One TRAIN epoch (both branches through the attention every step;
    only the ppr branch is cached), then serving: two calls on the same
    ids agree, and embed_nodes gives one block per branch."""
    _, ttr = ens_trainers
    calls = []

    def counted(*args):
        calls.append(args[3].shape)
        return gat_attention(*args)
    monkeypatch.setattr(tlayers, "gat_attention", counted)
    p0 = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    stats = ttr.run_epoch(0, TRAIN)
    nb = -(-len(ttr.entity_set[TRAIN]) // ttr.batch_size)
    assert np.isfinite(stats["loss"]) and len(calls) == nb * 2 * 2
    assert ttr.caches[TRAIN][0] is not None and ttr.caches[TRAIN][1] is None
    assert any(not torch.equal(p0[k], v) for k, v in ttr.model.state_dict().items())
    ids = np.asarray(ttr.entity_set[TEST])[:11]
    p1, p2 = ttr.predict_nodes(ids), ttr.predict_nodes(ids)
    np.testing.assert_array_equal(p1, p2)
    assert p1.shape == (11, C)
    np.testing.assert_allclose(p1.sum(1), 1.0, rtol=1e-5)
    emb = ttr.embed_nodes(ids)
    assert len(emb) == 2 and emb[1].shape == (11, DIM)
    np.testing.assert_allclose(np.linalg.norm(emb[1], axis=1), 1.0, rtol=1e-5)


def _directed(graph):
    """The dataset with one direction of a third of its edges dropped."""
    n = graph.num_nodes
    src = np.repeat(np.arange(n), np.diff(graph.indptr_full))
    dst = graph.indices_full
    drop = (src < dst) & (np.random.default_rng(0).random(src.size) < 0.33)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src[~drop], minlength=n))])
    return dataclasses.replace(graph, indptr_full=indptr.astype(np.int32),
                               indices_full=dst[~drop])


@pytest.mark.parametrize("power_law,directed,budget", [
    (False, False, None),          # uniform undirected: exact rows
    (False, True, None),           # directed within budget: exact rows
    (False, True, 1),              # directed over budget: the pairwise search
    (False, False, 1),             # undirected over budget: rows + hub table
])
def test_khop_plans_match_jax(monkeypatch, power_law, directed, budget):
    """The khop branch's plan in the other regimes of JAX's rules, the
    gather budget shrunk to put a graph over it."""
    graph = dict(GRAPH, power_law=power_law)
    jraw, traw = j_make(**graph), t_make(**graph)
    if directed:
        jraw, traw = _directed(jraw), _directed(traw)
    cfg = dict(ENS_CFG, sampler=ENS_CFG["sampler"][1:])
    jtr, ttr = _jax_trainer(jraw, cfg), Trainer("toy", "", traw, t_parse(cfg),
                                               seed=0, device="cpu")
    assert ttr.undirected == jtr.undirected == (not directed)
    if budget is not None:
        monkeypatch.setattr(jpipeline, "ROWS_GATHER_BUDGET", budget)
        monkeypatch.setattr(tpipeline, "PLAN_GATHER_BUDGET", budget)
        jtr.branches, ttr.branches = jtr._build_branches(), ttr._build_branches()
    for mode in (TRAIN, VALID, TEST):
        assert _fields(ttr, 0, mode) == _fields(jtr, 0, mode), mode
    kinds = {(True, None): "rows", (True, 1): "search"}
    want = kinds[(directed, budget)] if directed else "rows"
    assert ttr.branches[0]["cfg"][TEST].induction == want
    hubs = budget == 1 and not directed
    assert (ttr.branches[0]["cfg"][TEST].hub_slots > 0) == hubs
