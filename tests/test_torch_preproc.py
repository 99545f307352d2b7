"""PyTorch port: the preprocessing (``train/preproc.py``, ``ops/spmm.py``)
and the label inputs, against the JAX package on the same graph and the
same numpy inputs.  Host-side arrays (config decoding, one-hot label
tables) must be equal; smoothened signals allclose at rtol 1e-5 / atol
1e-6 with the same number of propagation steps (the same f32 products,
summed in edge order on both sides); model outputs at atol 1e-5 / rtol
1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.nn import model as jmodel
from shadow_gnn_tpu.ops import spmm as jspmm
from shadow_gnn_tpu.train import preproc as jpre
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.nn import model as tmodel
from shadow_gnn_torch.ops import spmm as tspmm
from shadow_gnn_torch.train import preproc as tpre
from shadow_gnn_torch.train.config import parse_config
from shadow_gnn_torch.train.pipeline import Trainer

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAPH = dict(num_nodes=600, avg_deg=8, num_feat=16, num_classes=5, seed=3)


@pytest.mark.parametrize("cfg", ["ppr--concat-0.8",            # the shipped one
                                 "ppr--concat-0.8-sym-none-0.015-100",
                                 "ppr--sum-0.5-rw-l1", "ppr--last-0.9-sym-max-0.001",
                                 "sym-2-concat", "rw-3-sum", "sym-1-last"])
def test_decode_smoothen_config_matches_jax(cfg):
    assert tpre.decode_smoothen_config(cfg) == jpre.decode_smoothen_config(cfg)


def test_decode_smoothen_config_rejects_bad_strings():
    for bad in ("ppr-concat", "sym-2", "sym-2-concat-x"):
        with pytest.raises(ValueError, match="bad smoothen config"):
            tpre.decode_smoothen_config(bad)


def test_spmm_edges_matches_jax():
    g = t_make(**GRAPH)
    x = np.random.default_rng(0).normal(size=(600, 7)).astype(np.float32)
    data = np.random.default_rng(1).random(g.indices_full.size).astype(np.float32)
    for d in (None, data):
        js, jd, jv = jspmm.csr_to_edges(g.indptr_full, g.indices_full, d)
        ts, td, tv = tspmm.csr_to_edges(g.indptr_full, g.indices_full, d)
        for a, b in ((js, ts), (jd, td), (jv, tv)):
            np.testing.assert_array_equal(a, b)
        want = np.asarray(jspmm.spmm_edges(jnp.asarray(js), jnp.asarray(jd),
                                           jnp.asarray(jv), jnp.asarray(x), 600))
        got = tspmm.spmm_edges(torch.as_tensor(ts).long(), torch.as_tensor(td).long(),
                               torch.as_tensor(tv), torch.as_tensor(x), 600)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _counting_spmm(monkeypatch):
    """Count the JAX package's propagation steps."""
    calls = []
    orig = jpre.spmm_edges

    def spmm(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(jpre, "spmm_edges", spmm)
    return calls


@pytest.mark.parametrize("cfg", ["ppr--concat-0.8", "ppr--last-0.5-rw-l1-0.001",
                                 "sym-2-concat", "rw-3-sum", "sym-1-last"])
def test_smooth_signal_full_matches_jax(cfg, monkeypatch):
    """Label-like and dense signals, with the same number of steps (the
    ppr iteration stops at its convergence check)."""
    g = t_make(**GRAPH)
    rng = np.random.default_rng(4)
    sig = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 600)]
    sig[rng.random(600) < 0.4] = 0.0
    tn, order, red, args = jpre.decode_smoothen_config(cfg)
    calls = _counting_spmm(monkeypatch)
    want = jpre.smooth_signal_full(g.indptr_full, g.indices_full, sig, tn, order,
                                   red, args)
    got, steps = tpre.smooth_signal_full(g.indptr_full, g.indices_full, sig, tn,
                                         order, red, args, device="cpu")
    assert steps == len(calls) and (tn != "ppr" or 1 < steps < args["itr_max"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_label", ["no_valid", "all"])
def test_prepare_raw_label_matches_jax(use_label):
    g = t_make(**GRAPH)
    want = jpre.prepare_raw_label(g.label_full, g.node_set, use_label, 600)
    got = tpre.prepare_raw_label(g.label_full, g.node_set, use_label, 600)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == len(g.node_set[0]) + (len(g.node_set[1])
                                              if use_label == "all" else 0)
    multi = (np.random.default_rng(1).random((600, 4)) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        tpre.prepare_raw_label(multi, g.node_set, use_label, 600),
        jpre.prepare_raw_label(multi, g.node_set, use_label, 600))
    with pytest.raises(ValueError):
        tpre.prepare_raw_label(g.label_full, g.node_set, "none", 600)


def _label_case():
    rng = np.random.default_rng(7)
    b, n, f, d_lab = 3, 12, 6, 4
    adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    arrays = dict(nodes=np.sort(rng.choice(100, (b, n)), -1).astype(np.int32),
                  node_mask=np.ones((b, n), bool), adj=adj,
                  targets=rng.integers(0, n, (b, 1)).astype(np.int32),
                  size=np.full(b, n, np.int32),
                  hop=rng.integers(-1, 4, (b, n)).astype(np.int32),
                  ppr=np.zeros((b, n), np.float32), drnl=np.zeros((b, n), np.int32))
    feat = rng.normal(size=(b, n, f + d_lab)).astype(np.float32)
    feat[..., f:] = np.abs(feat[..., f:]) + 0.5            # label inputs
    return arrays, feat, f, d_lab


@pytest.mark.parametrize("mode_train", [True, False])
def test_label_inputs_zeroed_at_targets_in_train_mode(mode_train):
    """The label-input columns are zeroed at the targets when the batch is
    of the TRAIN node set (mode_train), and only then; the feature
    columns never (SAGE with a hop augment, against flax apply)."""
    from shadow_gnn_tpu.sampling.batch import SubgraphBatch as JBatch
    from shadow_gnn_torch.sampling.batch import SubgraphBatch as TBatch
    arrays, feat, f, d_lab = _label_case()
    kw = dict(dim_feat_smooth=f, dim_label_raw=3, dim_label_smooth=d_lab,
              aggr="sage", num_layers=2, dim=8, feature_augment=("hops",))
    jcfg = jmodel.ModelConfig(dim_feat_raw=f, **kw)
    jm = jmodel.DeepGNN(jcfg)
    jb = [JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})]
    params = jm.init({"params": jax.random.PRNGKey(0)}, jb, [jnp.asarray(feat)],
                     mode_train=False, train=False)
    want, _ = jm.apply(params, jb, [jnp.asarray(feat)], mode_train=mode_train,
                       train=False)
    tm = tmodel.DeepGNN(tmodel.ModelConfig(**kw)).eval()
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    tb = {k: torch.as_tensor(v) for k, v in arrays.items()}
    for k in ("nodes", "targets", "hop", "drnl", "size"):
        tb[k] = tb[k].long()
    with torch.no_grad():
        got, _ = tm(TBatch(**tb), torch.as_tensor(feat), mode_train=mode_train)
        other, _ = tm(TBatch(**tb), torch.as_tensor(feat), mode_train=not mode_train)
        # the same logits as zeroing the targets' label columns by hand
        zeroed = feat.copy()
        zeroed[np.arange(3), arrays["targets"][:, 0], f:] = 0.0
        by_hand, _ = tm(TBatch(**tb), torch.as_tensor(zeroed if mode_train else feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), by_hand.numpy(), rtol=1e-6, atol=1e-6)
    assert not np.allclose(got.numpy(), other.numpy())


def _gat_cfg(preproc_method="full", transductive=True):
    return {"data": {"to_undirected": False, "transductive": transductive},
            "architecture": {"dim": 16, "aggr": "gat", "heads": 2, "num_layers": 1,
                             "act": "prelu", "feature_augment": "none",
                             "use_label": "no_valid",
                             "label_smoothen": "ppr--concat-0.8",
                             "residue": "max", "pooling": "max"},
            "hyperparameter": {"end": 1, "lr": 1e-3, "dropout": 0.0,
                               "batch_size": 32},
            "sampler": [{"method": preproc_method, "phase": "preprocess"},
                        {"method": "ppr", "phase": "train", "k": [16]}]}


def test_preprocess_signals_per_mode_matches_jax(monkeypatch, tmp_path):
    """Inductive data: each mode's rows are smoothed over its own
    adjacency (TRAIN over the TRAIN graph), rows outside every split stay
    zero; the trainer appends them as label inputs."""
    from shadow_gnn_tpu.data import load_data as j_load
    from shadow_gnn_torch.data import load_data as t_load, save_shadow_format
    import scipy.sparse as sp
    g = t_make(**GRAPH)
    a = sp.csr_matrix((np.ones(g.indices_full.size, np.float32), g.indices_full,
                       g.indptr_full), shape=(600, 600))
    in_train = np.zeros(600, np.float32)
    in_train[g.node_set[0]] = 1.0
    a_train = (sp.diags(in_train) @ a @ sp.diags(in_train)).tocsr()
    a_train.eliminate_zeros()
    save_shadow_format(str(tmp_path), "toy", indptr=g.indptr_full,
                       indices=g.indices_full, feat=g.feat_full,
                       label=g.label_full, node_set=g.node_set,
                       indptr_train=a_train.indptr, indices_train=a_train.indices)
    cfg_data = {"to_undirected": False, "transductive": False}
    raw_t = t_load(str(tmp_path), "toy", cfg_data)
    raw_j = j_load(str(tmp_path), "toy", cfg_data)
    assert raw_t.indptr_train is not None
    tr = Trainer("toy", "", raw_t, parse_config(_gat_cfg(transductive=False)),
                 seed=0, device="cpu")
    fake = dataclasses.make_dataclass("T", ["task", "_host_adj", "num_nodes",
                                            "entity_set"])(
        "node", {m: raw_j.adj(m) for m in (0, 1, 2)}, 600, raw_j.node_set)
    lab = jpre.prepare_raw_label(raw_j.label_full, raw_j.node_set, "no_valid", 600)
    calls = _counting_spmm(monkeypatch)
    want = jpre.smooth_signal_per_mode(
        fake, lab, *jpre.decode_smoothen_config("ppr--concat-0.8"))
    assert tr.dim_feat_smooth == 16 and tr.dim_label_smooth == 10
    assert tr.preproc_log["label_smoothen_steps"] == len(calls)
    np.testing.assert_allclose(tr.feat_np[:, 16:], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tr.feat_np[:, :16], raw_t.feat_full)
    assert np.abs(want[:, 5:]).max() > 0
    assert tr.model_cfg.dim_label_smooth == 10 and tr.model_cfg.mulhead == 2


def test_subgraph_preprocessing_is_refused():
    """Preprocessing inside sampled subgraphs is node-task only, as in
    JAX, and takes one preprocess sampler (a subgraph ensemble there is
    refused); the node task's runs (tests/test_torch_backbones_train.py)."""
    cfg = _gat_cfg("ppr")
    cfg["sampler"][0].update(k=[8, 12])
    with pytest.raises(ValueError, match="subgraph ensemble"):
        Trainer("toy", "", t_make(**GRAPH), parse_config(cfg), seed=0, device="cpu")
    link = {"data": {"to_undirected": True, "transductive": True},
            "architecture": {"dim": 16, "aggr": "sage", "loss": "sigmoid",
                             "num_layers": 1, "feature_augment": "drnls",
                             "feature_smoothen": "sym-1-concat"},
            "hyperparameter": {"end": 1, "lr": 1e-3, "batch_size": 16},
            "sampler": [{"method": "ppr", "phase": "preprocess", "k": [8]},
                        {"method": "ppr", "phase": "train", "k": [8]}]}
    with pytest.raises(NotImplementedError, match="node-task only"):
        Trainer("toy", "", t_make(300, 8.0, num_feat=8, seed=4, task="link"),
                parse_config(link), seed=0, device="cpu")
