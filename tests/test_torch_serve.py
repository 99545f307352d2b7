"""PyTorch port, the slice as a whole: SAGE-3 PPR serving from the
bit-packed cache.  The JAX Trainer (packed_adj, Pallas kernel in
interpret mode) and the port's Trainer (device="cpu", packed_adj) get
the same graph and the same weights (``params_from_flax``);
predict_nodes / embed_nodes must agree within atol 1e-5 / rtol 1e-4."""
import jax
import numpy as np
import pytest
import torch

from shadow_gnn_tpu import TEST
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger
from shadow_gnn_tpu.train.metrics import Metrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.ops.packed import packed_spmm
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import Trainer as TTrainer

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 32, "aggr": "sage", "loss": "softmax",
                     "num_layers": 3, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 5e-4, "dropout": 0.45,
                       "dropedge": 0.05, "batch_size": 32},
    "sampler": [{"method": "ppr", "phase": "train", "k": [16],
                 "epsilon": [1e-5]}],
}
GRAPH = dict(num_nodes=600, avg_deg=8, num_feat=16, num_classes=5, seed=3)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    m = Metrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**GRAPH), j_parse(CFG), m,
                   Logger(m, str(d / "log"), no_log=True), seed=0,
                   use_device_ppr=False, packed_adj=True)
    # the JAX Trainer serves from the cache once an epoch built it
    jtr._ensure_tables(TEST)
    jtr._ensure_caches(TEST)
    ttr = TTrainer("toy", "", t_make(**GRAPH), t_parse(CFG), seed=0,
                   device="cpu", packed_adj=True)
    ttr.model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params)))
    return jtr, ttr


@pytest.mark.parametrize("n_ids", [5, 9])       # 9 crosses the 8 -> 64 bucket
def test_predict_nodes_matches_jax(trainers, n_ids):
    jtr, ttr = trainers
    ids = np.asarray(jtr.entity_set[TEST])[[3 * i + 1 for i in range(n_ids)]]
    want = jtr.predict_nodes(ids, mode=TEST)
    calls = packed_spmm.calls
    got = ttr.predict_nodes(ids, mode=TEST)
    # 3 SAGE layers -> 3 packed aggregations: the cached packed path ran
    assert packed_spmm.calls == calls + 3
    assert ttr.caches[TEST][0] is not None
    assert got.shape == (n_ids, ttr.num_classes)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


def test_embed_nodes_matches_jax(trainers):
    jtr, ttr = trainers
    ids = np.asarray(jtr.entity_set[TEST])[[0, 7, 2, 7, 40]]
    want = jtr.embed_nodes(ids, mode=TEST)
    calls = packed_spmm.calls
    got = ttr.embed_nodes(ids, mode=TEST)
    assert packed_spmm.calls == calls + 3
    assert len(got) == 1 and got[0].shape == (5, ttr.model_cfg.dim)
    np.testing.assert_allclose(got[0], want[0], **TOL)


def test_uncached_dense_path_matches(trainers):
    """Sampling every request (no cache, dense aggregation) serves the
    same answers as the cached packed path."""
    jtr, ttr = trainers
    ids = np.asarray(jtr.entity_set[TEST])[:6]
    cached = ttr.predict_nodes(ids, mode=TEST)
    tr2 = TTrainer("toy", "", t_make(**GRAPH), t_parse(CFG), seed=0,
                   device="cpu", packed_adj=True)
    tr2.model.load_state_dict(ttr.model.state_dict())
    tr2.disable_cache(TEST)
    calls = packed_spmm.calls
    np.testing.assert_allclose(tr2.predict_nodes(ids, mode=TEST), cached,
                               rtol=1e-6, atol=1e-6)
    assert packed_spmm.calls == calls


def test_serving_rejects_bad_requests(trainers):
    _, ttr = trainers
    test_ids = np.asarray(ttr.entity_set[TEST])
    uncovered = np.setdiff1d(np.arange(ttr.num_nodes), test_ids)
    with pytest.raises(ValueError, match="not covered"):
        ttr.predict_nodes(uncovered[:1], mode=TEST)
    with pytest.raises(ValueError, match="empty"):
        ttr.predict_nodes([], mode=TEST)
