"""PyTorch port, the single-card capabilities of the JAX CLI and Trainer:
``matmul_precision="tensorfloat32"``, ``--meta_config``, ``--trace_dir``,
``--platform``, ``--data_tarball``, ``--device_ppr device`` and the
flags the port still refuses.

TF32 against JAX: one TRAIN epoch's per-batch losses of the flagship's
kind (SAGE, packed: B1c's plain version) and of a small GAT (JAX with
its fused Pallas attention in interpret mode, so both run the bf16
levels) at ``tensorfloat32``, same graph, seed and weights, dropout and
dropedge 0.  On the CPU both packages keep their dense products f32 and
round only in the kernels' bf16 modes; measured on an x86 CPU with 2
torch threads: SAGE 3.1e-5 and GAT 9.0e-5 relative at most, held at
5e-4.  JAX's process-wide precision is restored after each test.  The
TF32 switch is on inside the products of a TF32 model only and comes
back as it was."""
import json
import os
import sys
import tarfile

import jax
import numpy as np
import pytest
import torch
import yaml

from shadow_gnn_tpu import TRAIN as J_TRAIN
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch import TEST, TRAIN
from shadow_gnn_torch import main as tmain
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.data import save_shadow_format
from shadow_gnn_torch.ops import precision
from shadow_gnn_torch.ops.gat import gat_attention
from shadow_gnn_torch.ops.packed import packed_spmm
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.logger import Logger
from shadow_gnn_torch.train.pipeline import EpochRNG, Trainer

torch.set_num_threads(2)
GRAPH = dict(num_nodes=600, avg_deg=8, num_feat=16, num_classes=5, seed=3)
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
CLI_CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 16, "aggr": "sage", "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 2, "lr": 0.01, "dropout": 0.1, "dropedge": 0.05,
                       "batch_size": 32},
    "sampler": [{"method": "ppr", "phase": "train", "k": [12], "epsilon": [1e-5]}],
}
TF32_RTOL = 5e-4


@pytest.fixture
def jax_precision():
    """The JAX Trainer sets ``jax_default_matmul_precision`` for the whole
    process: restored after the test."""
    saved = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", saved)


@pytest.mark.parametrize("cfg", [SAGE_CFG, GAT_CFG], ids=["sage", "gat"])
def test_train_epoch_losses_match_jax_at_tf32(cfg, jax_precision):
    m = JMetrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**GRAPH), j_parse(cfg), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False,
                   packed_adj=True, matmul_precision="tensorfloat32",
                   fused_gat=cfg is GAT_CFG or None)
    ttr = Trainer("toy", "", t_make(**GRAPH), t_parse(cfg), seed=0, device="cpu",
                  packed_adj=True, matmul_precision="tensorfloat32")
    assert ttr.model_cfg.matmul_precision == "tensorfloat32"
    ttr.model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params)))
    # the first TRAIN epoch's steps, after each profile pass's draw
    jtr._ensure_tables(J_TRAIN)
    jtr._ensure_caches(J_TRAIN)
    jtr._profile_epoch(J_TRAIN)
    nb, roots, rows, lab, w, _, _ = jtr._epoch_arrays(J_TRAIN)
    rng = jax.random.PRNGKey(jtr.rng_np.integers(1 << 31))
    _, _, j_losses, _, _ = jtr._make_epoch_fn(J_TRAIN, nb, True)(
        jtr.params, jtr.opt_state, rng, roots, rows, lab, w,
        jtr._mode_arrays(J_TRAIN))
    ttr._ensure_tables(TRAIN)
    ttr._ensure_caches(TRAIN)
    ttr._profile_epoch(TRAIN)
    t_nb, t_roots, t_rows, t_lab, t_w = ttr._epoch_arrays(TRAIN)
    t_rng = EpochRNG.from_seed(int(ttr.rng_np.integers(1 << 31)), ttr.device)
    calls = packed_spmm.calls
    t_losses, _, _ = ttr._run_batches(TRAIN, True, t_nb, t_roots, t_rows, t_lab,
                                      t_w, t_rng)
    assert nb == t_nb == 12
    np.testing.assert_array_equal(np.asarray(roots).reshape(-1), t_roots.reshape(-1))
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=TF32_RTOL)
    # SAGE aggregates through the packed product, GAT not
    assert packed_spmm.calls - calls == (3 * 12 if cfg is SAGE_CFG else 0)


@pytest.mark.parametrize("cfg", [SAGE_CFG, GAT_CFG], ids=["sage", "gat"])
def test_tf32_runs_the_kernels_bf16_modes(cfg, monkeypatch):
    """At TF32 the packed product takes its bf16 mode and the attention
    its bf16 levels, as at bf16 precision."""
    seen = []
    if cfg is SAGE_CFG:
        from shadow_gnn_torch.nn import model as tmodel

        def spy(bits, x, norm="none", dropedge=0.0, seed=0, bf16=False):
            seen.append(bf16)
            return packed_spmm(bits, x, norm, dropedge, seed, bf16)

        monkeypatch.setattr(tmodel, "packed_spmm", spy)
    else:
        from shadow_gnn_torch.nn import layers

        def spy(a_s, a_n, v, adj_n, adj_s, bf16=False, bf16_scores=False):
            seen.append(bf16 and bf16_scores)
            return gat_attention(a_s, a_n, v, adj_n, adj_s, bf16, bf16_scores)

        monkeypatch.setattr(layers, "gat_attention", spy)
    tr = Trainer("toy", "", t_make(**GRAPH), t_parse(cfg), seed=0, device="cpu",
                 packed_adj=True, matmul_precision="tensorfloat32")
    p = tr.predict_nodes(np.asarray(tr.entity_set[TEST])[:8], TEST)
    assert np.isfinite(p).all() and seen and all(seen)


def test_tf32_switch_is_set_around_products_only(monkeypatch):
    """Inside every product ``ops/precision.py`` takes for a TF32 model
    (forward and backward) the TF32 switch is on; after the step it is
    what it was before, on or off; an f32 model leaves it as it is."""
    states = []

    def spied(real):
        def call(*args, **kw):
            if sys._getframe(1).f_globals["__name__"] == precision.__name__:
                states.append(torch.backends.cuda.matmul.allow_tf32)
            return real(*args, **kw)
        return call

    monkeypatch.setattr(torch, "matmul", spied(torch.matmul))
    monkeypatch.setattr(torch, "einsum", spied(torch.einsum))
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for cfg, prec in ((GAT_CFG, "tensorfloat32"), (SAGE_CFG, "tensorfloat32"),
                          (SAGE_CFG, "float32")):
            tr = Trainer("toy", "", t_make(**GRAPH), t_parse(cfg), seed=0,
                         device="cpu", matmul_precision=prec)
            tr._ensure_tables(TRAIN)
            for before in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = before
                states.clear()
                ent = np.asarray(tr.entity_set[TRAIN])[:32]
                batches, feats = tr._sample_branch_batches(
                    TRAIN, torch.as_tensor(ent[:, None]), torch.arange(32)[:, None])
                lab = torch.as_tensor(tr.label_np[ent].astype(np.int64))
                tr._train_step(batches, feats, lab, torch.ones(32),
                               EpochRNG.from_seed(1, tr.device))
                assert torch.backends.cuda.matmul.allow_tf32 is before
                assert len(states) > (10 if prec == "tensorfloat32" else 0)
                assert all(st is (True if prec == "tensorfloat32" else before)
                           for st in states)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class RecordingLogger(Logger):
    """A logger class a meta-config names; remembers its instances."""
    made = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        RecordingLogger.made.append(self)


def _toy_data(tmp_path, name="toy"):
    g = t_make(num_nodes=400, avg_deg=6, num_feat=8, num_classes=4, seed=1)
    ddir = str(tmp_path / "meta_data")
    save_shadow_format(ddir, name, indptr=g.indptr_full, indices=g.indices_full,
                       feat=g.feat_full, label=g.label_full, node_set=g.node_set)
    with open(tmp_path / "toy.yml", "w") as f:
        yaml.dump(CLI_CFG, f)
    return ddir


@pytest.mark.parametrize("fmt, logger", [
    ("json", "test_torch_capabilities:RecordingLogger"),
    ("yaml", "test_torch_capabilities.RecordingLogger")])
def test_meta_config(tmp_path, fmt, logger, capsys):
    """The meta-config's data and log dirs replace the flags', its metric
    map names the dataset's metric, the named logger class is used, and
    a config named in ``ignore_config_name`` leaves no run dir."""
    ddir = _toy_data(tmp_path)
    meta = {"data": {"dir": {"local": ddir}, "metric": {"toy": "f1"}},
            "logging": {"dir": {"local": str(tmp_path / "meta_logs")},
                        "logger": {"name": logger}}}
    path = tmp_path / f"meta.{fmt}"
    with open(path, "w") as f:
        (json.dump if fmt == "json" else yaml.dump)(meta, f)
    argv = ["--configs", str(tmp_path / "toy.yml"), "--dataset", "toy",
            "--data_dir", str(tmp_path / "absent"), "--log_dir", str(tmp_path / "x"),
            "--device", "cpu", "--meta_config", str(path), "--seed", "1"]
    RecordingLogger.made.clear()
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert "FINAL SUMMARY:" in out and "f1mic" in out
    assert len(RecordingLogger.made) == 1
    assert os.path.isdir(tmp_path / "meta_logs" / "toy" / "finished")
    assert not os.path.exists(tmp_path / "x")
    # ignore_config_name: the run leaves no files
    meta["logging"]["ignore_config_name"] = ["toy.yml"]
    meta["logging"]["dir"]["local"] = str(tmp_path / "ignored_logs")
    with open(path, "w") as f:
        (json.dump if fmt == "json" else yaml.dump)(meta, f)
    assert tmain.main(argv) == 0
    assert not os.path.exists(tmp_path / "ignored_logs")


def test_meta_config_unreadable(tmp_path):
    path = tmp_path / "meta.yml"
    path.write_text("data: [unclosed\n  - {\n")
    with pytest.raises(tmain.MetaConfigError, match="neither JSON"):
        tmain.read_meta_config(str(path))
    path.write_text('{"data": {"dir": {"local": "d"}}}')
    assert tmain.read_meta_config(str(path)) == {"data": {"dir": {"local": "d"}}}


def test_trace_dir_writes_a_trace(tmp_path):
    """TRAIN epoch 1 of a 2-epoch run is traced (CPU activities here) and
    written as a Chrome trace; no other epoch is."""
    tr = Trainer("toy", "", t_make(num_nodes=400, avg_deg=6, num_feat=8,
                                   num_classes=4, seed=1),
                 t_parse(CLI_CFG), seed=0, device="cpu", packed_adj=True)
    tr.trace_dir = str(tmp_path / "trace")
    tr.train()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_cli_trace_tf32_device_ppr_tarball(tmp_path, capsys):
    """One CLI run with every newly accepted flag: the dataset comes from
    an OGB-raw tarball, its PPR from the power iteration, its products at
    TF32, its epoch 1 into a trace; ``--platform cpu`` picks the CPU."""
    g = t_make(num_nodes=400, avg_deg=6, num_feat=8, num_classes=4, seed=1)
    pkg = tmp_path / "arxiv_pkg"
    os.makedirs(pkg / "raw"), os.makedirs(pkg / "split" / "time")
    src = np.repeat(np.arange(400), np.diff(g.indptr_full))
    np.savez(pkg / "raw" / "data.npz",
             edge_index=np.stack([src, g.indices_full]),
             node_feat=g.feat_full.astype(np.float32), num_nodes_list=np.array([400]),
             node_label=g.label_full[:, None])
    for name, mode in (("train", 0), ("valid", 1), ("test", 2)):
        np.save(pkg / "split" / "time" / f"{name}.npy", g.node_set[mode])
    with tarfile.open(tmp_path / "arxiv.tar.gz", "w:gz") as t:
        t.add(str(pkg), arcname="arxiv_pkg")
    with open(tmp_path / "toy.yml", "w") as f:
        yaml.dump(CLI_CFG, f)
    argv = ["--configs", str(tmp_path / "toy.yml"), "--dataset", "arxiv",
            "--data_dir", str(tmp_path / "data"), "--log_dir", str(tmp_path / "logs"),
            "--platform", "cpu", "--data_tarball", str(tmp_path / "arxiv.tar.gz"),
            "--device_ppr", "device", "--matmul_precision", "tensorfloat32",
            "--packed_adj", "--trace_dir", str(tmp_path / "trace"), "--seed", "1"]
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert "ingesting" in out and "FINAL SUMMARY:" in out
    assert "[profiler] train subgraph stats:" in out
    assert len(os.listdir(tmp_path / "trace")) == 1
    assert os.path.isdir(tmp_path / "data" / "arxiv" / "ppr_float")
    # the dataset is there now: a second run does not ingest again
    assert tmain.main(argv[:-5] + ["--seed", "2"]) == 0
    assert "ingesting" not in capsys.readouterr().out


CLI_BASE = ["--configs", "toy.yml", "--dataset", "toy"]


@pytest.mark.parametrize("flags, device", [
    (["--platform", "cpu"], "cpu"), (["--platform", "CPU"], "cpu"),
    (["--platform", "gpu"], "cuda"), (["--platform", "cuda"], "cuda"),
    (["--platform", "gpu", "--gpu", "1"], "cuda:1"),
    (["--platform", "cuda", "--device", "cuda:0"], "cuda:0")])
def test_cli_platform(flags, device):
    assert tmain.parse_args(CLI_BASE + flags).device == device


@pytest.mark.parametrize("flags, name", [
    (["--platform", "tpu"], "--platform tpu"),
    (["--platform", "cpu", "--device", "cuda"], "contradicts"),
    (["--platform", "cpu", "--gpu", "0"], "--gpu")])
def test_cli_platform_refused(flags, name, capsys):
    with pytest.raises(SystemExit) as exc:
        tmain.parse_args(CLI_BASE + flags)
    assert exc.value.code == 2 and name in capsys.readouterr().err


@pytest.mark.parametrize("flags, reason", [
    (["--distributed", "--partition", "dp"], None), (["--partition", "dp"], None),
    (["--partition_devices", "4"], None),
    (["--chunk_batches", "16"], "TPU-only"), (["--prng", "rbg"], "TPU-only")])
def test_cli_refuses_by_name(flags, reason, capsys):
    """The TPU-only flags are refused by name; the multi-card flags
    (``parallel/``, tests/test_torch_parallel.py) parse."""
    if reason is None:
        args = tmain.parse_args(CLI_BASE + flags)
        assert args.partition == ("dp" if "dp" in flags else "none")
        assert args.distributed == ("--distributed" in flags)
        assert args.partition_devices == (4 if "4" in flags else 0)
        return
    with pytest.raises(SystemExit) as exc:
        tmain.parse_args(CLI_BASE + flags)
    err = capsys.readouterr().err
    assert exc.value.code == 2 and flags[0] in err and reason in err


@pytest.mark.parametrize("flags, key, value", [
    (["--device_ppr", "device"], "device_ppr", "device"),
    (["--matmul_precision", "tensorfloat32"], "matmul_precision", "tensorfloat32"),
    (["--trace_dir", "t"], "trace_dir", "t"),
    (["--meta_config", "m.json"], "meta_config", "m.json"),
    (["--data_tarball", "d.tgz"], "data_tarball", "d.tgz")])
def test_cli_accepts(flags, key, value):
    assert getattr(tmain.parse_args(CLI_BASE + flags), key) == value
