"""PyTorch port, the bf16 precision trade through the Trainer and the CLI.

Against JAX: one TRAIN epoch's per-batch losses of the port's Trainer
and the JAX Trainer (same graph, seed and weights, dropout and dropedge
0) under ``matmul_precision="bfloat16"``, for the flagship kind (SAGE,
packed) and the products GAT kind, within 2e-2 relative: JAX on the CPU
rounds to bf16 only inside its Pallas kernels, the port rounds every
product (tests/test_torch_bf16_model.py).  ``feat_dtype="bfloat16"``:
the port's feature table is JAX's bf16 table bit for bit, and its
answers are the f32 port's on the pre-rounded table (atol 1e-6).  On
its own: the toy graph is learnt under each flag, a bf16 compute dtype
never reads the packed bits, and the CLI takes the three flags and
``--matmul_precision tensorfloat32``."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu import TRAIN as J_TRAIN
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch import TEST, TRAIN
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.data import save_shadow_format
from shadow_gnn_torch.ops.packed import packed_spmm
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import EpochRNG, Trainer

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = dict(num_nodes=600, avg_deg=8, num_feat=16, num_classes=5, seed=3)
# tests/test_torch_train.py's one-epoch configurations: the flagship's
# kind and the products GAT's kind, at test size
SAGE_CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 32, "aggr": "sage", "loss": "softmax",
                     "num_layers": 3, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 5e-4, "dropout": 0.0,
                       "dropedge": 0.0, "batch_size": 32},
    "sampler": [{"method": "ppr", "phase": "train", "k": [16],
                 "epsilon": [1e-5]}],
}
GAT_CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 32, "aggr": "gat", "heads": 2, "loss": "softmax",
                     "num_layers": 2, "act": "prelu", "feature_augment": "none",
                     "use_label": "no_valid", "label_smoothen": "ppr--concat-0.8",
                     "residue": "max", "pooling": "max"},
    "hyperparameter": {"end": 1, "lr": 1e-3, "dropout": 0.0, "dropedge": 0.0,
                       "batch_size": 32},
    "sampler": [{"method": "full", "phase": "preprocess"},
                {"method": "ppr", "phase": "train", "k": [16], "epsilon": [1e-5]}],
}
# tests/test_train_e2e.py's BASE_CONFIG (5 epochs, dropout, dropedge)
BASE_CONFIG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 32, "aggr": "sage", "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 5, "lr": 0.01, "dropout": 0.1,
                       "dropedge": 0.05, "batch_size": 32},
    "sampler": [{"method": "ppr", "phase": "train", "k": [16],
                 "epsilon": [1e-5]}],
}


@pytest.fixture
def jax_precision():
    """The JAX Trainer sets ``jax_default_matmul_precision`` for the whole
    process: restored after the test."""
    saved = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", saved)


@pytest.mark.parametrize("cfg", [SAGE_CFG, GAT_CFG], ids=["sage", "gat"])
def test_train_epoch_losses_match_jax_at_bf16_precision(cfg, jax_precision):
    m = JMetrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**GRAPH), j_parse(cfg), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False,
                   packed_adj=True, matmul_precision="bfloat16")
    jtr.profiler.enabled = False
    ttr = Trainer("toy", "", t_make(**GRAPH), t_parse(cfg), seed=0, device="cpu",
                  packed_adj=True, matmul_precision="bfloat16")
    ttr.profiler.enabled = False
    assert ttr.model_cfg.matmul_precision == "bfloat16"
    ttr.model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params)))
    jtr._ensure_tables(J_TRAIN)
    jtr._ensure_caches(J_TRAIN)
    nb, roots, rows, lab, w, _, _ = jtr._epoch_arrays(J_TRAIN)
    rng = jax.random.PRNGKey(jtr.rng_np.integers(1 << 31))
    _, _, j_losses, _, _ = jtr._make_epoch_fn(J_TRAIN, nb, True)(
        jtr.params, jtr.opt_state, rng, roots, rows, lab, w,
        jtr._mode_arrays(J_TRAIN))
    ttr._ensure_tables(TRAIN)
    ttr._ensure_caches(TRAIN)
    t_nb, t_roots, t_rows, t_lab, t_w = ttr._epoch_arrays(TRAIN)
    t_rng = EpochRNG.from_seed(int(ttr.rng_np.integers(1 << 31)), ttr.device)
    calls = packed_spmm.calls
    t_losses, _, _ = ttr._run_batches(TRAIN, True, t_nb, t_roots, t_rows, t_lab,
                                      t_w, t_rng)
    assert nb == t_nb == 12
    np.testing.assert_array_equal(np.asarray(roots).reshape(-1), t_roots.reshape(-1))
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=2e-2)
    # SAGE aggregates through the packed product (its bf16 mode), GAT not
    assert packed_spmm.calls - calls == (3 * 12 if cfg is SAGE_CFG else 0)


@pytest.mark.parametrize("flag", [dict(matmul_precision="bfloat16"),
                                  dict(compute_dtype="bfloat16"),
                                  dict(feat_dtype="bfloat16")],
                         ids=["matmul_precision", "compute_dtype", "feat_dtype"])
def test_train_learns_under_each_flag(flag):
    """tests/test_train_e2e.py's bf16 runs, on the port: TEST accuracy
    above 0.5 (chance 0.2).  A bf16 compute dtype takes the dense path:
    the cached batches carry the dense block and no packed product runs."""
    tr = Trainer("toy", "", t_make(**GRAPH), t_parse(BASE_CONFIG), seed=0,
                 device="cpu", packed_adj=True, **flag)
    dense = flag.get("compute_dtype") == "bfloat16"
    assert tr.model_cfg.reads_packed_bits is not dense
    calls = packed_spmm.calls
    final = tr.train()
    assert final[TEST]["accuracy"] > 0.5, final
    assert (packed_spmm.calls == calls) is dense
    batches, feats = tr._sample_branch_batches(
        TRAIN, torch.as_tensor(np.asarray(tr.entity_set[TRAIN])[:4, None]),
        torch.arange(4)[:, None])
    assert (batches[0].adj is not None) is dense
    assert feats[0].dtype == (torch.bfloat16 if dense else torch.float32)


def test_bf16_feature_table_matches_jax():
    m = JMetrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**GRAPH), j_parse(SAGE_CFG), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False,
                   feat_dtype="bfloat16")
    t16 = Trainer("toy", "", t_make(**GRAPH), t_parse(SAGE_CFG), seed=0,
                  device="cpu", packed_adj=True, feat_dtype="bfloat16")
    assert t16.feat_tab.dtype == torch.bfloat16
    want = np.asarray(jtr.feat_tab).view(np.uint16)
    np.testing.assert_array_equal(t16.feat_tab.view(torch.int16).numpy().view(np.uint16),
                                  want)
    # the f32 port on the pre-rounded table answers alike: the widening at
    # the gather is exact
    t32 = Trainer("toy", "", t_make(**GRAPH), t_parse(SAGE_CFG), seed=0,
                  device="cpu", packed_adj=True)
    t32.feat_tab = t16.feat_tab.float()
    ids = np.asarray(t16.entity_set[TEST])[:9]
    np.testing.assert_allclose(t16.predict_nodes(ids, TEST),
                               t32.predict_nodes(ids, TEST), rtol=0, atol=1e-6)
    for bad in (dict(feat_dtype="float16"), dict(compute_dtype="float16"),
                dict(matmul_precision="float16")):
        with pytest.raises(ValueError):
            Trainer("toy", "", t_make(**GRAPH), t_parse(SAGE_CFG), seed=0,
                    device="cpu", **bad)
    tf32 = Trainer("toy", "", t_make(**GRAPH), t_parse(SAGE_CFG), seed=0,
                   device="cpu", matmul_precision="tensorfloat32")
    assert tf32.model_cfg.matmul_precision == "tensorfloat32"


def test_cli_takes_the_precision_flags(tmp_path):
    import yaml
    g = t_make(num_nodes=400, avg_deg=6, num_feat=8, num_classes=4, seed=1)
    save_shadow_format(str(tmp_path / "data"), "toy", indptr=g.indptr_full,
                       indices=g.indices_full, feat=g.feat_full,
                       label=g.label_full, node_set=g.node_set)
    cfg = {**BASE_CONFIG,
           "hyperparameter": {**BASE_CONFIG["hyperparameter"], "end": 2}}
    with open(tmp_path / "toy.yml", "w") as f:
        yaml.dump(cfg, f)
    common = [sys.executable, "-m", "shadow_gnn_torch.main",
              "--configs", str(tmp_path / "toy.yml"), "--dataset", "toy",
              "--data_dir", str(tmp_path / "data"),
              "--log_dir", str(tmp_path / "logs"), "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(common + ["--seed", "1", "--packed_adj",
                                 "--matmul_precision", "bfloat16",
                                 "--compute_dtype", "bfloat16",
                                 "--feat_dtype", "bfloat16"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FINAL SUMMARY:" in r.stdout
    r = subprocess.run(common + ["--packed_adj", "--matmul_precision",
                                 "tensorfloat32"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FINAL SUMMARY:" in r.stdout
