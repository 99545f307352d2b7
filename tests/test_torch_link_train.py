"""PyTorch port, the link task's Trainer against the JAX Trainer on the
same synthetic link graph, seed and weights: two epochs of epoch arrays
(edges, labels, the TRAIN negatives from JAX's own numpy stream, the
permutations) bit for bit; one PPR push shared by the three modes (2k
wide, node-indexed rows for ``ppr_st``); one TRAIN epoch's per-batch
losses (a ``ppr`` branch, which samples deterministically) and the VALID
stats with hits@20 after it, and the VALID pass of a ``ppr_st``
trainer, at rtol 1e-4; the inference cost per edge
(``compute_complexity``, sort pooling included).  On its own: the
refusals of serving and of the full-graph passes, ``train()`` ->
checkpoint -> ``load_run`` + ``inference``, and the CLI (training,
``--inference_dir``, ``valedges_as_input``'s ``-wval_`` PPR caches)."""
import glob
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from shadow_gnn_tpu import TRAIN as J_TRAIN, VALID as J_VALID
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.train.complexity import compute_complexity as j_complexity
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch import TEST, TRAIN, VALID
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.data import save_shadow_format
from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_t
from shadow_gnn_torch.train.complexity import compute_complexity as t_complexity
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.logger import Logger
from shadow_gnn_torch.train.metrics import Metrics
from shadow_gnn_torch.train.pipeline import EpochRNG, Trainer

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = dict(num_nodes=300, avg_deg=8.0, num_feat=8, seed=4, task="link")
# the collab leaderboard model's kind at test size
CFG = {
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
CFG_ST = {**CFG, "sampler": [{**CFG["sampler"][0], "method": "ppr_st"}]}


def _trainers(cfg, load=True):
    m = JMetrics("toy", True, "hits20", 1)
    jtr = JTrainer("toy", "", j_make(**GRAPH), j_parse(cfg), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False,
                   packed_adj=True)
    jtr.profiler.enabled = False
    ttr = Trainer("toy", "", t_make(**GRAPH), t_parse(cfg),
                  Metrics("toy", True, "hits20", 1), seed=0, device="cpu",
                  packed_adj=True)
    if load:
        ttr.model.load_state_dict(params_from_flax(
            jax.tree_util.tree_map(np.asarray, jtr.params), prediction_task="link"))
    return jtr, ttr


def test_epoch_arrays_and_negatives_match_jax():
    """Two epochs of TRAIN and VALID arrays: the roots ([M, 2] edges,
    which are also the table rows), the labels, the weights and the
    permutations equal JAX's; the TRAIN negatives (drawn anew each epoch)
    avoid self loops and graph edges."""
    jtr, ttr = _trainers(CFG_ST, load=False)
    g = t_make(**GRAPH)
    keys = set((np.repeat(np.arange(300), np.diff(g.indptr_full)) * 300
                + g.indices_full).tolist())
    negs = []
    for _ in range(2):
        for jm, tm in ((J_VALID, VALID), (J_TRAIN, TRAIN)):
            nb, roots, rows, _, _, labels, w = jtr._epoch_arrays(jm)
            t_nb, t_roots, t_rows, t_labels, t_w = ttr._epoch_arrays(tm)
            assert t_nb == nb and t_roots.shape == (nb * 16, 2)
            np.testing.assert_array_equal(t_roots, np.asarray(roots).reshape(-1, 2))
            np.testing.assert_array_equal(t_rows, t_roots)
            np.testing.assert_array_equal(t_labels, labels)
            np.testing.assert_array_equal(t_w, w)
            assert t_labels.shape == (nb * 16, 1)
        neg = t_roots[(t_labels[:, 0] == 0) & (t_w > 0)]
        assert (neg[:, 0] != neg[:, 1]).all()
        assert not keys & set((neg[:, 0] * 300 + neg[:, 1]).tolist())
        negs.append(neg)
    assert nb == 16 and t_nb == 16                   # 25% of 512 + 512 TRAIN
    assert not np.array_equal(negs[0], negs[1])
    # the negative stream is JAX's: the next draw equals its next draw
    np.testing.assert_array_equal(ttr._negative_sample(512), jtr._negative_sample(512))


def test_ppr_tables_shared_across_modes():
    """One push for the three modes (ppr_st in TRAIN, its ppr reading in
    VALID/TEST): one table object, 2k = 24 wide, a row per node."""
    _, ttr = _trainers(CFG_ST, load=False)
    calls = []
    orig = ttr._compute_ppr
    ttr._compute_ppr = lambda *a, **kw: calls.append(a) or orig(*a, **kw)
    for md in (TRAIN, VALID, TEST):
        ttr._ensure_tables(md)
    assert len(calls) == 1 and calls[0][2] == 24
    tab = ttr.tables[TRAIN][0]
    assert tab is ttr.tables[VALID][0] is ttr.tables[TEST][0]
    assert tuple(tab.neighs.shape) == (300, 24)
    cfg = ttr.branches[0]["cfg"]
    assert (cfg[TRAIN].method, cfg[VALID].method, cfg[TEST].method) == \
        ("ppr_st", "ppr", "ppr")
    assert cfg[TRAIN].n_pad == 32 and cfg[TRAIN].num_targets == 2
    assert not cfg[TRAIN].include_target_conn
    assert {k: v for k, v in vars(cfg[TRAIN]).items() if k != "method"} == \
        {k: v for k, v in vars(cfg[VALID]).items() if k != "method"}


@pytest.fixture(scope="module")
def one_epoch():
    """One TRAIN epoch (a ppr branch) on both trainers, then VALID."""
    jtr, ttr = _trainers(CFG)
    jtr._ensure_tables(J_TRAIN)
    nb, roots, rows, lab, w, _, _ = jtr._epoch_arrays(J_TRAIN)
    rng = jax.random.PRNGKey(jtr.rng_np.integers(1 << 31))
    fn = jtr._make_epoch_fn(J_TRAIN, nb, True)
    jtr.params, jtr.opt_state, j_losses, _, _ = fn(
        jtr.params, jtr.opt_state, rng, roots, rows, lab, w,
        jtr._mode_arrays(J_TRAIN))
    ttr._ensure_tables(TRAIN)
    t_nb, t_roots, t_rows, t_lab, t_w = ttr._epoch_arrays(TRAIN)
    t_rng = EpochRNG.from_seed(int(ttr.rng_np.integers(1 << 31)), ttr.device)
    counts = (packed_spmm.calls, packed_spmm_t.launches, gat_attention.launches,
              gat_attention_bwd.launches)
    t_losses, _, ovf = ttr._run_batches(TRAIN, True, t_nb, t_roots, t_rows,
                                        t_lab, t_w, t_rng)
    after = (packed_spmm.calls, packed_spmm_t.launches, gat_attention.launches,
             gat_attention_bwd.launches)
    return dict(jtr=jtr, ttr=ttr, nb=(nb, t_nb), losses=(np.asarray(j_losses), t_losses),
                ovf=ovf, counts=tuple(a - b for a, b in zip(after, counts)),
                valid=(jtr.run_epoch(0, J_VALID), ttr.run_epoch(0, VALID)))


def test_train_epoch_losses_match_jax(one_epoch):
    assert one_epoch["nb"] == (16, 16) and one_epoch["ovf"] == 0
    j_losses, t_losses = one_epoch["losses"]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert len(set(t_losses.tolist())) > 1
    # packed_adj on a link model: every batch took the dense block
    assert one_epoch["counts"] == (0, 0, 0, 0)
    assert one_epoch["ttr"].nocache_modes == {TRAIN, VALID, TEST}


def test_valid_stats_match_jax(one_epoch):
    j_stats, t_stats = one_epoch["valid"]
    assert set(t_stats) == {"loss", "hits20"}
    np.testing.assert_allclose(t_stats["loss"], j_stats["loss"], rtol=1e-4)
    assert t_stats["hits20"] == j_stats["hits20"]


def test_ppr_st_valid_pass_matches_jax():
    """A ppr_st trainer's VALID pass reads the 2k tables as ppr (its
    first k places): deterministic, so the stats equal JAX's."""
    jtr, ttr = _trainers(CFG_ST)
    j_stats, t_stats = jtr.run_epoch(0, J_VALID), ttr.run_epoch(0, VALID)
    np.testing.assert_allclose(t_stats["loss"], j_stats["loss"], rtol=1e-4)
    assert t_stats["hits20"] == j_stats["hits20"]


def test_complexity_matches_jax():
    jtr, ttr = _trainers(CFG_ST, load=False)
    want = j_complexity(jtr, num_roots_budget=64)
    got = t_complexity(ttr, num_roots_budget=64)
    np.testing.assert_allclose(got[VALID], want[J_VALID], rtol=1e-6)
    assert got[VALID] > 0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_link")
    metrics = Metrics("toy", True, "hits20", 1)
    cfg = {**CFG_ST, "hyperparameter": {**CFG_ST["hyperparameter"], "end": 2,
                                        "dropout": 0.25, "dropedge": 0.1}}
    tr = Trainer("toy", str(d), t_make(**GRAPH), t_parse(cfg), metrics,
                 Logger(metrics, str(d / "log")), seed=0, device="cpu",
                 packed_adj=True)
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    return d, cfg, tr, tr.train(), p0


def test_train_runs_and_moves_parameters(trained):
    _, _, tr, final, p0 = trained
    for m in (TRAIN, VALID, TEST):
        assert np.isfinite(final[m]["loss"]) and 0.0 <= final[m]["hits20"] <= 1.0
    assert all(not torch.equal(p0[k], v) for k, v in tr.model.state_dict().items())


def test_link_refuses_serving_and_full_passes(trained):
    tr = trained[2]
    for call in (lambda: tr.predict_nodes([1, 2]), lambda: tr.embed_nodes([1]),
                 lambda: tr.predict_full(), lambda: tr.embed_full()):
        with pytest.raises(NotImplementedError, match="node task only"):
            call()


def test_load_run_and_inference(trained):
    """A new trainer loads the run's checkpoint and its inference pass
    reproduces the final VALID and TEST stats."""
    d, cfg, tr, final, _ = trained
    metrics = Metrics("toy", True, "hits20", 1)
    tr2 = Trainer("toy", str(d), t_make(**GRAPH), t_parse(cfg), metrics,
                  Logger(metrics, "", no_log=True), seed=5, device="cpu")
    tr2.load_run(str(d / "log"))
    for k, v in tr.model.state_dict().items():
        assert torch.equal(tr2.model.state_dict()[k], v), k
    summary = tr2.inference()
    assert summary.startswith("FINAL SUMMARY")
    for m in (VALID, TEST):
        got = tr2.logger.final_stats[m]
        assert got["hits20"] == final[m]["hits20"]
        np.testing.assert_allclose(got["loss"], final[m]["loss"], rtol=1e-6)


def _cli(tmp, *flags):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "shadow_gnn_torch.main", "--dataset", "collab",
         "--data_dir", str(tmp / "data"), "--log_dir", str(tmp / "logs"),
         "--device", "cpu", *flags],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r


def _hits(out: str, mode: str) -> float:
    line = [ln for ln in out.splitlines() if ln.startswith("FINAL SUMMARY")][-1]
    return float(re.search(rf"{mode}: loss=[0-9.]+, hits50=([0-9.]+)", line).group(1))


def test_cli_link_trains_infers_and_caches_wval_ppr(tmp_path):
    """A link dataset named collab (hits@50) with ``valedges_as_input``:
    trains through the CLI, writes only ``-wval_`` PPR caches, and
    ``--inference_dir`` reproduces the run's TEST hits@50."""
    g = t_make(**GRAPH)
    pos = g.edge_set[VALID]["pos"]
    src = np.repeat(np.arange(300), np.diff(g.indptr_full))
    key = np.unique(np.r_[src * 300 + g.indices_full, pos[:, 0] * 300 + pos[:, 1],
                          pos[:, 1] * 300 + pos[:, 0]])
    indptr_wv = np.concatenate([[0], np.cumsum(np.bincount(key // 300, minlength=300))])
    save_shadow_format(str(tmp_path / "data"), "collab", indptr=g.indptr_full,
                       indices=g.indices_full, feat=g.feat_full, label=None,
                       edge_set=g.edge_set, indptr_with_val=indptr_wv,
                       indices_with_val=key % 300)
    cfg = {**CFG_ST, "data": {**CFG_ST["data"], "valedges_as_input": True},
           "hyperparameter": {**CFG_ST["hyperparameter"], "end": 2, "dropout": 0.25}}
    with open(tmp_path / "link.yml", "w") as f:
        yaml.dump(cfg, f)
    r = _cli(tmp_path, "--configs", str(tmp_path / "link.yml"), "--seed", "1",
             "--packed_adj")
    assert "hits50" in r.stdout
    caches = glob.glob(str(tmp_path / "data" / "collab" / "ppr_float" / "*"))
    assert caches and all("-wval_" in os.path.basename(c) for c in caches)
    run_dir = glob.glob(str(tmp_path / "logs" / "collab" / "finished" / "*"))[0]
    r2 = _cli(tmp_path, "--inference_dir", run_dir)
    assert "PERFORM INFERENCE TASK" in r2.stdout
    assert abs(_hits(r2.stdout, "test") - _hits(r.stdout, "test")) <= 1e-6
    r3 = _cli(tmp_path, "--inference_dir", run_dir, "--compute_complexity_only")
    assert "Average inference cost per node" in r3.stdout
