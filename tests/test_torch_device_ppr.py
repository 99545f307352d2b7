"""PyTorch port, the device PPR power iteration, its memory plan and the
PPR shard files (``sampling/ppr.py``, ``ppr_precompute.py``) against the
JAX package.

``plan_device_ppr`` equals JAX's over a grid of graph and memory sizes;
``ppr_power_device`` on the CPU gives JAX's CPU scores within rtol 1e-5
and the same neighbour sets outside ties at the k-th score, in blocks
that pad the last one; the Trainer's ``use_device_ppr`` picks the push
or the power iteration as JAX's does and caches either; sharded tables
merge into a bin cache pair byte-equal to JAX's merge and to the
unsharded write; the port's precompute CLI writes that same pair."""
import os

import numpy as np
import pytest

from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.native import ppr_push_native as j_push
from shadow_gnn_tpu.sampling import ppr as jppr
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch import TRAIN, VALID
from shadow_gnn_torch import ppr_precompute
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.data import save_shadow_format
from shadow_gnn_torch.native import ppr_push_native as t_push
from shadow_gnn_torch.sampling import ppr as tppr
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import Trainer

ALPHA, EPS, K = 0.85, 1e-5, 24
CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 16, "aggr": "sage", "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 1e-3, "dropout": 0.0, "dropedge": 0.0,
                       "batch_size": 32},
    "sampler": [{"method": "ppr", "phase": "train", "k": [K], "epsilon": [EPS]}],
}


@pytest.fixture(scope="module")
def graph():
    return t_make(num_nodes=500, avg_deg=8, num_feat=8, num_classes=4, seed=5,
                  power_law=True)


def _assert_tables_agree(got, want, k, rtol=1e-5):
    """Per target: the same list length, scores within ``rtol``, and the
    same neighbours among those scored above the k-th score (a tie at the
    boundary may pick either node)."""
    for (gn, gs), (wn, ws) in zip(zip(*got), zip(*want)):
        assert gn.size == wn.size
        np.testing.assert_allclose(gs, ws, rtol=rtol, atol=0)
        if wn.size < k:
            assert set(gn.tolist()) == set(wn.tolist())
            continue
        cut = ws[-1] * (1 + 2 * rtol)
        assert set(gn[gs > cut].tolist()) == set(wn[ws > cut].tolist())


@pytest.mark.parametrize("num_nodes", [1_000, 2_000_000, 30_000_000])
@pytest.mark.parametrize("num_edges", [10_000, 400_000_000])
@pytest.mark.parametrize("memory", [None, 16 << 30, 80 * 10**9])
def test_plan_device_ppr_matches_jax(num_nodes, num_edges, memory):
    for want_batch, min_batch in ((512, 256), (1024, 64)):
        assert (tppr.plan_device_ppr(num_nodes, num_edges, memory, want_batch,
                                     min_batch)
                == jppr.plan_device_ppr(num_nodes, num_edges, memory, want_batch,
                                        min_batch))


def test_device_memory_bytes_on_the_cpu():
    assert tppr.device_memory_bytes("cpu") is None


@pytest.mark.parametrize("batch", [64, 200])
def test_ppr_power_device_matches_jax(graph, batch):
    """Blocks of ``batch`` targets, the last one padded; two runs equal."""
    targets = np.arange(3, 500, 2)
    want = jppr.ppr_power_device(graph.indptr_full, graph.indices_full, targets,
                                 K, ALPHA, batch=batch)
    got = tppr.ppr_power_device(graph.indptr_full, graph.indices_full, targets,
                                K, ALPHA, batch=batch, device="cpu")
    assert len(got[0]) == targets.size
    _assert_tables_agree(got, want, K)
    again = tppr.ppr_power_device(graph.indptr_full, graph.indices_full, targets,
                                  K, ALPHA, batch=batch, device="cpu")
    for a, b in zip(got[0] + got[1], again[0] + again[1]):
        np.testing.assert_array_equal(a, b)
    assert all(s.dtype == np.float32 and (s > 0).all() for s in got[1])
    assert all(n.dtype == np.int32 for n in got[0])


@pytest.mark.parametrize("use_device_ppr", [None, True])
def test_trainer_use_device_ppr(tmp_path, graph, use_device_ppr):
    """None plans (the host push), True runs the power iteration, as the
    JAX Trainer does; either writes the PPR cache, which a second
    trainer reads instead of computing."""
    ddir = str(tmp_path / "data")
    save_shadow_format(ddir, "toy", indptr=graph.indptr_full,
                       indices=graph.indices_full, feat=graph.feat_full,
                       label=graph.label_full, node_set=graph.node_set)
    m = JMetrics("toy", False, "accuracy", 1)
    jg = j_make(num_nodes=500, avg_deg=8, num_feat=8, num_classes=4, seed=5,
                power_law=True)
    jtr = JTrainer("toy", "", jg, j_parse(CFG), m, JLogger(m, "", no_log=True),
                   seed=0, use_device_ppr=use_device_ppr)
    ttr = Trainer("toy", ddir, graph, t_parse(CFG), seed=0, device="cpu",
                  use_device_ppr=use_device_ppr)
    assert ttr.use_device_ppr == jtr.use_device_ppr == bool(use_device_ppr)
    jtr._ensure_tables(TRAIN)
    ttr._ensure_tables(TRAIN)
    jt, tt = jtr.tables[TRAIN][0], ttr.tables[TRAIN][0]
    jn, js = np.asarray(jt.neighs), np.asarray(jt.scores)
    tn, ts = tt.neighs.numpy(), tt.scores.numpy()
    if use_device_ppr:
        _assert_tables_agree(([r[r >= 0] for r in tn], [s[s > 0] for s in ts]),
                             ([r[r >= 0] for r in jn], [s[s > 0] for s in js]), K)
    else:
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(ts, js)
    fn, fs = tppr.find_ppr_cache(ddir, "toy", True, "train", ALPHA, EPS, K)
    assert fn is not None and os.path.isfile(fs)

    def no_compute(*args, **kw):
        raise AssertionError("the cache was not read")

    again = Trainer("toy", ddir, graph, t_parse(CFG), seed=0, device="cpu",
                    use_device_ppr=use_device_ppr)
    tppr_push, tppr_power = tppr.ppr_push_host, tppr.ppr_power_device
    tppr.ppr_push_host = tppr.ppr_power_device = no_compute
    try:
        again._ensure_tables(TRAIN)
    finally:
        tppr.ppr_push_host, tppr.ppr_power_device = tppr_push, tppr_power
    np.testing.assert_array_equal(again.tables[TRAIN][0].neighs.numpy(), tn)
    np.testing.assert_array_equal(again.tables[TRAIN][0].scores.numpy(), ts)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n_shards", [1, 3])
def test_merged_shards_match_jax_and_unsharded(tmp_path, graph, n_shards):
    ip, ix = graph.indptr_full, graph.indices_full
    targets = np.asarray(graph.node_set[TRAIN], dtype=np.int64)
    paths = {}
    for pkg, ppr, push in (("jax", jppr, j_push), ("torch", tppr, t_push)):
        fn, fs = ppr.ppr_cache_paths(str(tmp_path / pkg), "toy", True, "train",
                                     ALPHA, EPS, K)
        for h in range(n_shards):
            sel = ppr.shard_targets(targets, h, n_shards)
            tab_n, tab_s = push(ip, ix, sel, K, 1.0 - ALPHA, EPS, as_dense=True)
            ppr.write_ppr_shard(ppr.ppr_shard_path(fn, h, n_shards), sel, tab_n,
                                tab_s, K, ALPHA, EPS)
        ppr.merge_ppr_shards(fn, fs, graph.num_nodes, n_shards, K, ALPHA, EPS)
        assert not os.path.exists(ppr.ppr_shard_path(fn, 0, n_shards))
        paths[pkg] = (fn, fs)
    fn, fs = tppr.ppr_cache_paths(str(tmp_path / "whole"), "toy", True, "train",
                                  ALPHA, EPS, K)
    neighs, scores = tppr.ppr_push_host(ip, ix, targets, K, ALPHA, EPS)
    tppr.write_ppr_cache(fn, fs, graph.num_nodes, targets, neighs, scores, K,
                         ALPHA, EPS)
    for i in range(2):
        assert _read(paths["torch"][i]) == _read(paths["jax"][i])
        assert _read(paths["torch"][i]) == _read((fn, fs)[i])
    nv, sv = tppr.read_ppr_cache(*paths["torch"], K, ALPHA, EPS)
    for t, n, s in zip(targets, neighs, scores):
        np.testing.assert_array_equal(nv[t], n)
        np.testing.assert_array_equal(sv[t], s)


def test_merge_refuses_bad_shards(tmp_path):
    fn = str(tmp_path / "ppr_float" / "neighs_x_24.bin")
    fs = fn.replace("neighs", "scores")
    tab = np.zeros((2, K), np.int32), np.ones((2, K), np.float32)
    tppr.write_ppr_shard(tppr.ppr_shard_path(fn, 0, 2), [1, 2], *tab, K, ALPHA, EPS)
    tppr.write_ppr_shard(tppr.ppr_shard_path(fn, 1, 2), [2, 3], *tab, K, ALPHA, EPS)
    with pytest.raises(ValueError, match="overlapping"):
        tppr.merge_ppr_shards(fn, fs, 10, 2, K, ALPHA, EPS)
    with pytest.raises(ValueError, match="meta mismatch"):
        tppr.merge_ppr_shards(fn, fs, 10, 2, K, 0.5, EPS)
    with pytest.raises(ValueError, match="shard 2"):
        tppr.shard_targets(np.arange(5), 2, 2)


def test_precompute_cli(tmp_path, graph, capsys):
    """Two shards and a merge through the port's CLI: the bin pair equals
    the JAX package's write of the same tables, and a Trainer reads it."""
    ddir = str(tmp_path / "data")
    save_shadow_format(ddir, "toy", indptr=graph.indptr_full,
                       indices=graph.indices_full, feat=graph.feat_full,
                       label=graph.label_full, node_set=graph.node_set)
    base = ["--data_dir", ddir, "--dataset", "toy", "--mode", "valid",
            "--k", str(K), "--epsilon", str(EPS), "--n_shards", "2"]
    for h in (0, 1):
        assert ppr_precompute.main(base + ["--shard", str(h)]) == 0
    assert ppr_precompute.main(base + ["--merge"]) == 0
    assert "[merge] 2 shards" in capsys.readouterr().out
    targets = np.asarray(graph.node_set[VALID], dtype=np.int64)
    n, s = j_push(graph.indptr_full, graph.indices_full, targets, K, 1.0 - ALPHA,
                  EPS)
    fn, fs = jppr.ppr_cache_paths(str(tmp_path / "jax"), "toy", True, "valid",
                                  ALPHA, EPS, K)
    jppr.write_ppr_cache(fn, fs, graph.num_nodes, targets, n, s, K, ALPHA, EPS)
    ours = tppr.ppr_cache_paths(ddir, "toy", True, "valid", ALPHA, EPS, K)
    assert _read(ours[0]) == _read(fn) and _read(ours[1]) == _read(fs)
    tr = Trainer("toy", ddir, graph, t_parse(CFG), seed=0, device="cpu")
    tr._ensure_tables(VALID)
    assert tr.tables[VALID][0].neighs.shape == (targets.size, K)
