"""PyTorch port, the training slice as a whole.

Against JAX: the JAX Trainer (packed_adj, Pallas kernel in interpret
mode) and the port's Trainer (device="cpu", packed_adj) get the same
graph, the same seed and the same weights (``params_from_flax``) at
dropout 0 and dropedge 0; one TRAIN epoch's per-batch losses and the
VALID stats after it must agree (rtol 1e-4; accuracy exactly), and the
port's clip + Adam must equal optax's (atol 1e-7).  The same for a GAT-2
model of the products leaderboard kind (heads, prelu, max residue and
pooling, ppr-smoothened label inputs), which also serves
(``predict_nodes`` atol 1e-5 / rtol 1e-4); and the products GAT-5 yml
builds the JAX Trainer's parameter shapes.  On its own: the
port's ``train()`` learns the toy graph, writes the CSV files and a
checkpoint that reloads, and the CLI trains end to end."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shadow_gnn_tpu import TEST as J_TEST, TRAIN as J_TRAIN, VALID as J_VALID
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
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
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.logger import Logger
from shadow_gnn_torch.train.metrics import Metrics
from shadow_gnn_torch.train.pipeline import (EpochRNG, Trainer,
                                             clip_grad_global_norm_,
                                             make_optimizer)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = dict(num_nodes=600, avg_deg=8, num_feat=16, num_classes=5, seed=3)
CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 32, "aggr": "sage", "loss": "softmax",
                     "num_layers": 3, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 5e-4, "dropout": 0.0,
                       "dropedge": 0.0, "batch_size": 32},
    "sampler": [{"method": "ppr", "phase": "train", "k": [16],
                 "epsilon": [1e-5]}],
}
# tests/test_train_e2e.py's BASE_CONFIG
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


# the products GAT-5 leaderboard model's kind at test size
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


def _run_one_epoch(cfg):
    """One TRAIN epoch, then one VALID epoch, on both trainers."""
    m = JMetrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**GRAPH), j_parse(cfg), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False,
                   packed_adj=True)
    # the JAX Trainer's first-epoch subgraph profile draws an extra
    # permutation from rng_np; the port has no profiler
    jtr.profiler.enabled = False
    ttr = Trainer("toy", "", t_make(**GRAPH), t_parse(cfg), seed=0,
                  device="cpu", packed_adj=True)
    ttr.model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params)))

    # JAX: run_epoch(0, TRAIN)'s steps, keeping the per-batch losses
    jtr._ensure_tables(J_TRAIN)
    jtr._ensure_caches(J_TRAIN)
    nb, roots, rows, lab, w, _, _ = jtr._epoch_arrays(J_TRAIN)
    rng = jax.random.PRNGKey(jtr.rng_np.integers(1 << 31))
    fn = jtr._make_epoch_fn(J_TRAIN, nb, True)
    jtr.params, jtr.opt_state, j_losses, _, _ = fn(
        jtr.params, jtr.opt_state, rng, roots, rows, lab, w,
        jtr._mode_arrays(J_TRAIN))
    # the port: run_epoch(0, TRAIN)'s steps
    ttr._ensure_tables(TRAIN)
    ttr._ensure_caches(TRAIN)
    t_nb, t_roots, t_rows, t_lab, t_w = ttr._epoch_arrays(TRAIN)
    t_rng = EpochRNG.from_seed(int(ttr.rng_np.integers(1 << 31)), ttr.device)
    counts = (packed_spmm.calls, packed_spmm_t.launches, gat_attention.launches,
              gat_attention_bwd.launches)
    t_losses, _, ovf = ttr._run_batches(TRAIN, True, t_nb, t_roots, t_rows,
                                        t_lab, t_w, t_rng)
    return dict(jtr=jtr, ttr=ttr, nb=(nb, t_nb),
                roots=(np.asarray(roots).reshape(-1), t_roots.reshape(-1)),
                losses=(np.asarray(j_losses), t_losses), ovf=ovf,
                calls=packed_spmm.calls - counts[0],
                launches=(packed_spmm_t.launches - counts[1],
                          gat_attention.launches - counts[2],
                          gat_attention_bwd.launches - counts[3]),
                valid=(jtr.run_epoch(0, J_VALID), ttr.run_epoch(0, VALID)))


@pytest.fixture(scope="module")
def one_epoch():
    return _run_one_epoch(CFG)


@pytest.fixture(scope="module")
def gat_epoch():
    return _run_one_epoch(GAT_CFG)


def test_train_epoch_losses_match_jax(one_epoch):
    j_nb, t_nb = one_epoch["nb"]
    assert j_nb == t_nb == 12                          # 360 TRAIN nodes / 32
    # rng_np is consumed in JAX's order: the same epoch permutation
    np.testing.assert_array_equal(*one_epoch["roots"])
    j_losses, t_losses = one_epoch["losses"]
    assert t_losses.shape == (12,) and one_epoch["ovf"] == 0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    # every step aggregated 3 times through the packed product; on the
    # CPU nothing counts as a kernel launch
    assert one_epoch["calls"] == 3 * 12 and one_epoch["launches"] == (0, 0, 0)


def test_gat_train_epoch_losses_match_jax(gat_epoch):
    """The GAT-2 trainer: the same preprocessed feature table (features
    and ppr-smoothened label inputs), the same epoch permutation, the
    per-batch losses of one TRAIN epoch at rtol 1e-4.  With packed_adj
    the GAT model still gets the dense block (it reads no packed bits)."""
    jtr, ttr = gat_epoch["jtr"], gat_epoch["ttr"]
    np.testing.assert_array_equal(ttr.feat_np, jtr.feat_np)
    assert (ttr.dim_feat_smooth, ttr.dim_label_smooth) == (16, 10)
    assert ttr.preproc_log["label_smoothen_steps"] > 1
    assert ttr.branches[0]["cfg"][TRAIN].add_self_edge
    j_nb, t_nb = gat_epoch["nb"]
    assert j_nb == t_nb == 12
    np.testing.assert_array_equal(*gat_epoch["roots"])
    j_losses, t_losses = gat_epoch["losses"]
    assert gat_epoch["ovf"] == 0 and gat_epoch["calls"] == 0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert gat_epoch["launches"] == (0, 0, 0)


def test_gat_valid_stats_and_serving_match_jax(gat_epoch):
    j_stats, t_stats = gat_epoch["valid"]
    assert t_stats["accuracy"] == j_stats["accuracy"]
    np.testing.assert_allclose(t_stats["loss"], j_stats["loss"], rtol=1e-4)
    jtr, ttr = gat_epoch["jtr"], gat_epoch["ttr"]
    ids = np.asarray(jtr.entity_set[J_TEST])[[3 * i + 1 for i in range(9)]]
    np.testing.assert_allclose(ttr.predict_nodes(ids, mode=TEST),
                               jtr.predict_nodes(ids, mode=J_TEST),
                               rtol=1e-4, atol=1e-5)
    emb = ttr.embed_nodes(ids[:4], mode=TEST)
    np.testing.assert_allclose(emb[0], jtr.embed_nodes(ids[:4], mode=J_TEST)[0],
                               rtol=1e-4, atol=1e-5)


def test_products_gat5_config_builds_at_full_width():
    """configs/products_gat_5_ppr_leaderboard.yml as written: the port's
    Trainer (device="cpu", a small graph) has the JAX Trainer's parameter
    names and shapes (dim 512, 4 heads of 128, 5 layers, max readout);
    nothing runs a step at that width."""
    path = os.path.join(ROOT, "configs", "products_gat_5_ppr_leaderboard.yml")
    m = JMetrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**GRAPH), j_parse(path), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False)
    ttr = Trainer("toy", "", t_make(**GRAPH), t_parse(path), seed=0, device="cpu")
    want = {k: tuple(v.shape) for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params)).items()}
    got = {k: tuple(v.shape) for k, v in ttr.model.state_dict().items()}
    assert got == want
    assert got["convs.4.attention"] == (2, 4, 128)
    assert got["convs.0.lin_self.weight"] == (512, 16 + 2 * 5)
    assert got["res_pool.lin.weight"] == (512, 1024)
    cfg = ttr.model_cfg
    assert (cfg.aggr, cfg.mulhead, cfg.num_layers, cfg.act, cfg.residue,
            cfg.pooling) == ("gat", 4, 5, "prelu", "max", "max")
    assert (cfg.dropout, cfg.dropedge, ttr.batch_size) == (0.4, 0.1, 128)
    assert ttr.branches[0]["cfg"][TRAIN].n_pad == 152


def test_valid_stats_match_jax_after_training(one_epoch):
    j_stats, t_stats = one_epoch["valid"]
    assert t_stats["accuracy"] == j_stats["accuracy"]
    np.testing.assert_allclose(t_stats["loss"], j_stats["loss"], rtol=1e-4)


def test_optimizer_matches_optax():
    """Given the same gradients, clip-by-global-norm 5 + Adam equals
    optax.chain(clip_by_global_norm(5), adam(lr)), step by step: one
    step clipped (norm 20), one not (norm 0.5), one at the edge.  Each
    step's update is held at atol 1e-7 (updates are ~lr = 0.01; optax
    forms the bias corrections in f32, where 1 - 0.999 = 9.99987e-4, torch
    in double: 7e-8 apart).  The parameters are small (0.01 scale), so an
    f32 ulp of theirs is far below that."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 5), "b": (5,), "s": (2, 3)}
    params = {k: (0.01 * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()}
    lr = 0.01
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(lr))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = opt.init(j_params)
    t_params = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    t_opt = make_optimizer(list(t_params.values()), lr)
    for target in (20.0, 0.5, 5.0):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        scale = target / np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                     for v in g.values()))
        g = {k: (v * scale).astype(np.float32) for k, v in g.items()}
        upd, j_state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        before = {k: p.detach().clone() for k, p in t_params.items()}
        for k, p in t_params.items():
            p.grad = torch.as_tensor(g[k])
        norm = clip_grad_global_norm_(list(t_params.values()), 5.0)
        np.testing.assert_allclose(norm.item(), target, rtol=1e-5)
        t_opt.step()
        for k in shapes:
            np.testing.assert_allclose((t_params[k].detach() - before[k]).numpy(),
                                       np.asarray(upd[k]), rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train")
    metrics = Metrics("toy", False, "accuracy", 1)
    logger = Logger(metrics, str(d / "log"))
    tr = Trainer("toy", str(d), t_make(**GRAPH), t_parse(BASE_CONFIG), metrics,
                 logger, seed=0, device="cpu", packed_adj=True)
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    calls = packed_spmm.calls
    final = tr.train()
    return d, tr, final, p0, packed_spmm.calls - calls


def test_train_learns(trained):
    _, tr, final, p0, calls = trained
    assert final[TEST]["accuracy"] > 0.5, final       # chance = 0.2
    for m in (TRAIN, VALID, TEST):
        assert np.isfinite(final[m]["loss"])
    assert any(not torch.equal(p0[k], v) for k, v in tr.model.state_dict().items())
    # 5 epochs x (12 TRAIN + 4 VALID batches) + final 12 + 4 + 4, 2 layers
    assert calls == 2 * (5 * 16 + 20)
    assert not tr.model.training
    # serving still answers after training
    probs = tr.predict_nodes(np.asarray(tr.entity_set[TEST])[:5], mode=TEST)
    assert probs.shape == (5, tr.num_classes)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)


def test_train_writes_artifacts_and_checkpoint_reloads(trained):
    d, tr, _, _, _ = trained
    for f in ("epoch_train.csv", "epoch_valid.csv", "final.csv"):
        assert os.path.isfile(d / "log" / f)
    with open(d / "log" / "epoch_train.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == "epoch, train_loss, train_accuracy" and len(lines) == 6
    ckpts = list((d / "log").glob("saved_model_*.pt"))
    assert len(ckpts) == 1 and list((d / "log").glob("saved_optimizer_*.pt"))
    model_sd, opt_sd = Logger.load_checkpoint(str(d / "log" / "saved_model_*.pt"),
                                              str(d / "log" / "saved_optimizer_*.pt"))
    assert set(model_sd) == set(tr.model.state_dict()) and "state" in opt_sd
    before = tr.run_epoch(99, TEST, status="final")
    tr.model.load_state_dict(model_sd)
    after = tr.run_epoch(99, TEST, status="final")
    assert abs(before["accuracy"] - after["accuracy"]) < 1e-6


def test_trainer_needs_cuda_unless_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer("toy", "", t_make(**GRAPH), t_parse(CFG), seed=0)


def test_cli_end_to_end(tmp_path):
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
              "--log_dir", str(tmp_path / "logs")]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(common + ["--seed", "1", "--device", "cpu", "--packed_adj"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FINAL SUMMARY:" in r.stdout
    finished = list((tmp_path / "logs" / "toy" / "finished").iterdir())
    assert len(finished) == 1
    assert (finished[0] / "final.csv").is_file()
    assert (finished[0] / "config.yml").is_file()
    # a flag of an unported part is refused by name, so is the dense GAT
    # score chain
    for flag in (["--partition", "dp"], ["--fused_gat", "off"]):
        r = subprocess.run(common + ["--device", "cpu"] + flag,
                           capture_output=True, text=True, env=env, cwd=ROOT,
                           timeout=300)
        assert r.returncode == 2 and flag[0] in r.stderr


CLI_BASE = ["--configs", "toy.yml", "--dataset", "toy"]


@pytest.mark.parametrize("flags, device", [
    ([], "cuda"), (["--gpu", "0"], "cuda:0"), (["--gpu", "2"], "cuda:2"),
    (["--gpu", "1", "--device", "cuda:0"], "cuda:0"),
    (["--device", "cpu"], "cpu")])
def test_cli_gpu_flag(flags, device):
    """``--gpu N`` selects ``cuda:N`` unless ``--device`` is given (the
    parsed arguments only: no Trainer is built)."""
    from shadow_gnn_torch.main import parse_args
    assert parse_args(CLI_BASE + flags).device == device


@pytest.mark.parametrize("mode", ["auto", "host"])
def test_cli_device_ppr_host(mode):
    from shadow_gnn_torch.main import parse_args
    assert parse_args(CLI_BASE + ["--device_ppr", mode]).device_ppr == mode


@pytest.mark.parametrize("flags, name", [
    (["--device_ppr", "device"], "--device_ppr device"),
    (["--gpu", "0", "--device", "cpu"], "--gpu")])
def test_cli_refuses(flags, name, capsys):
    """``--device_ppr device`` (the unported device power iteration) is
    refused by name, and so is ``--gpu`` beside ``--device cpu``."""
    from shadow_gnn_torch.main import parse_args
    with pytest.raises(SystemExit) as exc:
        parse_args(CLI_BASE + flags)
    assert exc.value.code == 2 and name in capsys.readouterr().err
