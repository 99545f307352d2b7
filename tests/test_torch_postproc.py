"""PyTorch port: the post-processing and the inference cost count.

Correct & Smooth (``postproc/cns.py``: the edge list, the propagation
with and without the symmetric scaling, the accuracy lists, and
``run_correct_smooth`` on a prediction matrix that JAX's
``_gen_pred_mat`` wrote), the post-ensemble (``postproc/ens.py``:
``ModelPostEns`` under ``post_ens_params_from_flax``,
``train_post_ensemble`` from shared initial parameters at dropout 0,
``ensemble_multirun``'s pairing) and ``train/complexity.py``, each held
against the JAX function on the same numpy inputs: integers and
accuracies exactly, floats at atol 1e-5 / rtol 1e-4."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.data import save_shadow_format
from shadow_gnn_tpu.nn.model import ModelConfig as JConfig
from shadow_gnn_tpu.postproc import cns as jcns
from shadow_gnn_tpu.postproc import ens as jens
from shadow_gnn_tpu.train import complexity as jcx
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch import TEST, TRAIN, VALID
from shadow_gnn_torch.convert import post_ens_params_from_flax
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.nn.model import ModelConfig as TConfig
from shadow_gnn_torch.postproc import cns as tcns
from shadow_gnn_torch.postproc import ens as tens
from shadow_gnn_torch.train import complexity as tcx
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import Trainer as TTrainer

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
N, C = 600, 5


def _graph_with_self_loops():
    """A directed graph (no reverse edges) with a few stored self loops
    and a duplicate edge once reversed."""
    g = t_make(num_nodes=N, avg_deg=6, num_feat=4, num_classes=C, seed=2)
    src = np.repeat(np.arange(N), np.diff(g.indptr_full))
    keep = src < g.indices_full                   # one direction only
    src, dst = src[keep], g.indices_full[keep]
    src = np.concatenate([src, [3, 7, 9, 11]])
    dst = np.concatenate([dst, [3, 7, 9, 10]])    # self loops 3, 7, 9
    order = np.lexsort((dst, src))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=N))])
    return indptr.astype(np.int64), dst[order].astype(np.int32), g


def test_cs_edges_match_jax():
    indptr, indices, _ = _graph_with_self_loops()
    got, want = tcns._cs_edges(indptr, indices), jcns._cs_edges(indptr, indices)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_norm", [False, True])
def test_outcome_correlation_matches_jax(use_norm):
    indptr, indices, _ = _graph_with_self_loops()
    y0 = np.random.default_rng(1).random((N, C)).astype(np.float32)
    want = jcns.general_outcome_correlation(indptr, indices, y0, use_norm=use_norm)
    got = tcns.general_outcome_correlation(indptr, indices, y0, use_norm=use_norm,
                                           device="cpu")
    np.testing.assert_allclose(got, want, **TOL)
    # the edge-partitioned propagation runs on the ranks of a group of
    # n_shards (tests/test_torch_edgepart.py); outside one it raises
    with pytest.raises(RuntimeError, match="n_shards=2 runs inside a process group"):
        tcns.general_outcome_correlation(indptr, indices, y0, n_shards=2,
                                         device="cpu")


def _preds(g, seed):
    """A noisy prediction matrix: the label's column raised, then
    row-normalised."""
    rng = np.random.default_rng(seed)
    p = rng.random((g.num_nodes, C)).astype(np.float32)
    p[np.arange(g.num_nodes), g.label_full] += 0.4
    return p / p.sum(1, keepdims=True)


@pytest.mark.parametrize("use_norm", [False, True])
def test_correct_smooth_accuracies_match_jax(use_norm):
    indptr, indices, g = _graph_with_self_loops()
    preds = [_preds(g, 0), _preds(g, 1)]
    want = jcns.correct_smooth(indptr, indices, g.label_full, g.node_set, preds,
                               use_norm, 0.8)
    got = tcns.correct_smooth(indptr, indices, g.label_full, g.node_set, preds,
                              use_norm, 0.8, device="cpu")
    assert got == want
    assert all(len(v) == 2 for v in got[1].values())
    with pytest.raises(RuntimeError, match="n_shards=4 runs inside a process group"):
        tcns.correct_smooth(indptr, indices, g.label_full, g.node_set, preds,
                            use_norm, 0.8, n_shards=4, device="cpu")


@pytest.mark.parametrize("use_norm", [False, True])
def test_correct_smooth_n_shards_1_outside_a_group(use_norm):
    """``n_shards=1`` in a process of no group runs the edge-partitioned
    propagation in this process (it raised before): JAX's accuracies,
    the same as ``n_shards=0``."""
    indptr, indices, g = _graph_with_self_loops()
    preds = [_preds(g, 0), _preds(g, 1)]
    want = jcns.correct_smooth(indptr, indices, g.label_full, g.node_set, preds,
                               use_norm, 0.8, n_shards=1)
    got = tcns.correct_smooth(indptr, indices, g.label_full, g.node_set, preds,
                              use_norm, 0.8, n_shards=1, device="cpu")
    assert got == want


SAGE_CFG = {
    "data": {"to_undirected": True, "transductive": True},
    "architecture": {"dim": 16, "aggr": "sage", "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 5e-3, "dropout": 0.0, "dropedge": 0.0,
                       "batch_size": 16},
    "sampler": [{"method": "ppr", "phase": "train", "k": [12], "epsilon": [1e-5]}],
}


def test_run_correct_smooth_on_jax_pred_mat(tmp_path):
    """JAX's ``_gen_pred_mat`` writes ``pred_mat_gen.npy`` into a JAX run
    dir; the port's ``run_correct_smooth`` reads it (a run dir with a
    stored matrix needs no checkpoint) and gives JAX's accuracies."""
    g = j_make(num_nodes=400, avg_deg=8, num_feat=8, num_classes=4, seed=1)
    data = str(tmp_path / "data")
    save_shadow_format(data, "toy", indptr=g.indptr_full, indices=g.indices_full,
                       feat=g.feat_full, label=g.label_full, node_set=g.node_set)
    run = tmp_path / "run"
    m = JMetrics("toy", False, "accuracy", 1)
    lg = JLogger(m, str(run), config_dump=SAGE_CFG)
    from shadow_gnn_tpu.data.loader import load_data as j_load
    jtr = JTrainer("toy", data, j_load(data, "toy", SAGE_CFG["data"]),
                   j_parse(SAGE_CFG), m, lg, seed=0, use_device_ppr=False)
    lg.save_checkpoint(jtr.params, jtr.opt_state)
    args = types.SimpleNamespace(data_dir=data, dataset="toy", postproc_dir=None,
                                 device="cpu")
    pred = jcns._gen_pred_mat(args, str(run))
    assert (run / "pred_mat_gen.npy").is_file()
    cfg = {"method": "cs", "dir_pred_mat": [str(run)],
           "hyperparameter": {"norm_sym": True, "alpha": 0.75}}
    raw = j_load(data, "toy", {"to_undirected": True, "transductive": True})
    want = jcns.correct_smooth(raw.indptr_full, raw.indices_full, raw.label_full,
                               raw.node_set, [pred], True, 0.75)
    assert tcns.run_correct_smooth(args, cfg) == want


def _emb_task(n_ens, dim_in=12, seed=0):
    """Class-correlated embedding matrices of ``n_ens`` branches over N
    nodes, labels and splits."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, C, N)
    centers = rng.normal(size=(n_ens, C, dim_in))
    embs = [(0.6 * centers[i][label] + rng.normal(size=(N, dim_in))).astype(np.float32)
            for i in range(n_ens)]
    perm = rng.permutation(N)
    node_set = {TRAIN: np.sort(perm[:360]), VALID: np.sort(perm[360:480]),
                TEST: np.sort(perm[480:])}
    return embs, label, node_set


def _jax_post_model(n_ens, dim_hid, act="leakyrelu"):
    return jens.ModelPostEns(dim_hid=dim_hid, num_classes=C, num_ensemble=n_ens,
                             act=act)


@pytest.mark.parametrize("n_ens, act", [(1, "leakyrelu"), (3, "leakyrelu"),
                                        (3, "prelu")])
def test_post_ens_forward_matches_jax(n_ens, act):
    embs, _, _ = _emb_task(n_ens)
    jm = _jax_post_model(n_ens, 8, act)
    x = [jnp.asarray(e[:20]) for e in embs]
    params = jm.init({"params": jax.random.PRNGKey(3)}, x, train=False)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(5), p.shape), params)
    want = jm.apply(params, x, train=False)
    tm = tens.ModelPostEns(12, 8, C, n_ens, act=act).eval()
    tm.load_state_dict(post_ens_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = tm([torch.as_tensor(e[:20]) for e in embs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(NotImplementedError):
        post_ens_params_from_flax({"Dense_0": {}})


def _jax_losses(embs, label, node_set, arch, hp, seed):
    """Every step's loss of JAX's ``train_post_ensemble`` (its init, its
    optimizer, its permutations), re-run step by step."""
    model = _jax_post_model(len(embs), arch["dim"])
    je = [jnp.asarray(e) for e in embs]
    rng = jax.random.PRNGKey(seed)
    params = model.init({"params": rng, "dropout": rng}, [e[:2] for e in je],
                        train=False)
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(hp["lr"]))
    state = opt.init(params)
    tr_idx = np.asarray(node_set[TRAIN])
    rng_np = np.random.default_rng(seed)
    bs, losses = hp["batch_size"], []

    def lf(p, idx):
        logits = model.apply(p, [e[idx] for e in je], train=True)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                    jnp.asarray(label)[idx][:, None], -1).mean()

    for _ in range(hp["end"]):
        perm = rng_np.permutation(tr_idx.size)
        nb = tr_idx.size // bs
        for idx in tr_idx[perm[:nb * bs]].reshape(nb, bs):
            loss, grads = jax.value_and_grad(lf)(params, idx)
            upd, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, upd)
            losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("n_ens", [1, 2])
def test_train_post_ensemble_matches_jax(n_ens):
    embs, label, node_set = _emb_task(n_ens, seed=n_ens)
    arch = {"dim": 8, "act": "leakyrelu", "loss": "softmax"}
    hp = {"lr": 0.01, "batch_size": 64, "end": 4, "dropout": 0.0}
    want = jens.train_post_ensemble(node_set, embs, label, arch, hp, seed=1)
    want_losses, _ = _jax_losses(embs, label, node_set, arch, hp, seed=1)
    # the initial parameters JAX's function draws from seed 1
    model = _jax_post_model(n_ens, 8)
    init = model.init({"params": jax.random.PRNGKey(1),
                       "dropout": jax.random.PRNGKey(1)},
                      [jnp.asarray(e[:2]) for e in embs], train=False)
    losses = []
    got = tens.train_post_ensemble(
        node_set, embs, label, arch, hp, seed=1, device="cpu",
        init_state=post_ens_params_from_flax(jax.tree_util.tree_map(np.asarray, init)),
        losses=losses)
    assert len(losses) == len(want_losses) == 4 * (360 // 64)
    np.testing.assert_allclose([float(x) for x in losses], want_losses, **TOL)
    assert got == want
    assert got[TEST] > 1.5 / C


def test_ensemble_multirun_pairing_matches_jax(monkeypatch):
    """Run i of every sampler type is joined in the dict's order, and each
    joined list trained ``repeat`` times with seeds 0 .. repeat-1."""
    calls = {"jax": [], "torch": []}

    def recorder(key):
        def fake(node_set, emb_list, label, arch, params_cfg, seed=0, **kw):
            calls[key].append(([int(e[0, 0]) for e in emb_list], seed))
            return {TRAIN: seed, VALID: len(emb_list), TEST: int(emb_list[0][0, 0])}
        return fake

    monkeypatch.setattr(jens, "train_post_ensemble", recorder("jax"))
    monkeypatch.setattr(tens, "train_post_ensemble", recorder("torch"))

    def tag(v):
        return np.full((2, 2), v, np.float32)

    pipe = {"ppr": [[tag(1), tag(2)], [tag(3), tag(4)]],
            "khop": [[tag(5)], [tag(6)]]}
    want = jens.ensemble_multirun({}, pipe, None, {}, {}, repeat=3)
    got = tens.ensemble_multirun({}, pipe, None, {}, {}, repeat=3, device="cpu")
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][:4] == [([1, 2, 5], 0), ([1, 2, 5], 1), ([1, 2, 5], 2),
                                  ([3, 4, 6], 0)]
    assert got == want


# ------------------------------------------------------------- complexity
@pytest.mark.parametrize("aggr, pooling, residue, n_ens", [
    ("sage", "center", "none", 1), ("gat", "max", "max", 2),
    ("gcn", "mean", "concat", 1), ("gin", "sum", "sum", 3),
    ("mlp", "center", "concat", 1)])
def test_batch_complexity_matches_jax(aggr, pooling, residue, n_ens):
    common = dict(dim_feat_smooth=20, dim_label_raw=C, dim_label_smooth=0,
                  aggr=aggr, num_layers=3, dim=32, heads=4, residue=residue,
                  pooling=pooling, feature_augment=("hops",), num_ensemble=n_ens)
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 30, 16)
    edges = rng.integers(0, 200, 16)
    want = jcx.batch_complexity(JConfig(dim_feat_raw=20, **common), sizes, edges, 27)
    got = tcx.batch_complexity(TConfig(**common), sizes, edges, 27)
    assert got == want


# two ppr branches, sum residue and mean pooling: the ensemble's count
ENS_CFG = {**SAGE_CFG,
           "architecture": {**SAGE_CFG["architecture"], "residue": "sum",
                            "pooling": "mean"},
           "sampler": [{"method": "ppr", "phase": "train", "k": [12, 20],
                        "epsilon": [1e-5, 1e-5]}]}


@pytest.mark.parametrize("cfg, budget", [(SAGE_CFG, 0), (ENS_CFG, 40)])
def test_compute_complexity_matches_jax(cfg, budget):
    """The mean cost per VALID root over sampled batches (the whole mode,
    or the first batches up to ``budget`` roots)."""
    graph = dict(num_nodes=N, avg_deg=8, num_feat=12, num_classes=C, seed=4)
    m = JMetrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**graph), j_parse(cfg), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False)
    ttr = TTrainer("toy", "", t_make(**graph), t_parse(cfg), seed=0, device="cpu",
                   packed_adj=True)
    want = jcx.compute_complexity(jtr, num_roots_budget=budget)
    got = tcx.compute_complexity(ttr, num_roots_budget=budget)
    assert set(got) == {VALID}
    np.testing.assert_allclose(got[VALID], want[VALID], rtol=1e-12)
    # the packed bits of a cached batch count the same edges
    ttr._ensure_caches(VALID)
    ttr.rng_np = np.random.default_rng(0)
    np.testing.assert_allclose(tcx.compute_complexity(ttr, budget)[VALID],
                               want[VALID], rtol=1e-12)
