"""PyTorch port: the CLI's inference, reload, post-processing and cost
tasks, run as subprocesses under ``--device cpu`` on a toy dataset: a
run is trained once, then ``--inference_dir`` reproduces its final TEST
accuracy, ``--inference_configs`` evaluates the checkpoint of
``--reload_model_dir`` (with ``--is_inf_train``), ``--reload_model_dir``
resumes training from it, ``--postproc_configs`` runs C&S (making the
run's prediction matrix by inference) and the post-ensemble (making its
embedding matrices), ``--postproc_dir`` adds a run to C&S, an
``n_shards`` C&S runs over spawned ranks, and ``--compute_complexity_only``
reports the cost per node."""
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import yaml

from shadow_gnn_torch.data import make_synthetic_dataset, save_shadow_format

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {
    "data": {"to_undirected": True, "transductive": True},
    "architecture": {"dim": 16, "aggr": "sage", "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 2, "lr": 5e-3, "dropout": 0.1, "dropedge": 0.0,
                       "batch_size": 16},
    "sampler": [{"method": "ppr", "phase": "train", "k": [12], "epsilon": [1e-5]}],
}


def _cli(tmp, *flags, ok=True):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "shadow_gnn_torch.main", "--dataset", "toy",
         "--data_dir", str(tmp / "data"), "--log_dir", str(tmp / "logs"),
         "--device", "cpu", *flags],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    if ok:
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r


def _test_acc(summary_out: str) -> float:
    line = [ln for ln in summary_out.splitlines() if ln.startswith("FINAL SUMMARY")][-1]
    return float(re.search(r"test: loss=[0-9.]+, accuracy=([0-9.]+)", line).group(1))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(tmp dir, the finished run dir, its training output)."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    g = make_synthetic_dataset(num_nodes=400, avg_deg=8, num_feat=8, num_classes=4,
                               seed=1)
    save_shadow_format(str(tmp / "data"), "toy", indptr=g.indptr_full,
                       indices=g.indices_full, feat=g.feat_full,
                       label=g.label_full, node_set=g.node_set)
    with open(tmp / "toy.yml", "w") as f:
        yaml.dump(CFG, f)
    r = _cli(tmp, "--configs", str(tmp / "toy.yml"), "--seed", "1")
    run_dir = glob.glob(str(tmp / "logs" / "toy" / "finished" / "*"))[0]
    assert glob.glob(f"{run_dir}/saved_model_*.pt")
    return tmp, run_dir, r.stdout


def test_inference_dir_reproduces_test_accuracy(run):
    tmp, run_dir, out = run
    r = _cli(tmp, "--inference_dir", run_dir)
    assert "PERFORM INFERENCE TASK" in r.stdout
    assert abs(_test_acc(r.stdout) - _test_acc(out)) <= 1e-6
    assert "train:" not in r.stdout.splitlines()[-1]


def test_inference_configs_reload_model_dir_is_inf_train(run):
    tmp, run_dir, out = run
    r = _cli(tmp, "--inference_configs", str(tmp / "toy.yml"),
             "--reload_model_dir", run_dir, "--is_inf_train")
    summary = r.stdout.splitlines()[-1]
    assert "train: loss=" in summary and "valid: loss=" in summary
    assert abs(_test_acc(r.stdout) - _test_acc(out)) <= 1e-6
    # without a checkpoint to read, the task is refused
    r = _cli(tmp, "--inference_configs", str(tmp / "toy.yml"), ok=False)
    assert r.returncode == 2 and "--reload_model_dir" in r.stderr


def test_train_resumes_from_reload_model_dir(run):
    tmp, run_dir, _ = run
    _cli(tmp, "--configs", str(tmp / "toy.yml"), "--reload_model_dir", run_dir,
         "--seed", "2")
    new = [d for d in glob.glob(str(tmp / "logs" / "toy" / "finished" / "*"))
           if d != run_dir]
    assert any(glob.glob(f"{d}/loaded_saved_model_*.pt") for d in new)
    assert any(glob.glob(f"{d}/loaded_saved_optimizer_*.pt") for d in new)


def test_postproc_cs_then_ensemble(run):
    tmp, run_dir, _ = run
    with open(tmp / "cs.yml", "w") as f:
        yaml.dump({"method": "cs", "dir_pred_mat": [run_dir],
                   "hyperparameter": {"norm_sym": False, "alpha": 0.8}}, f)
    r = _cli(tmp, "--postproc_configs", str(tmp / "cs.yml"))
    assert "PERFORM POSTPROC TASK" in r.stdout and "C&S acc" in r.stdout
    pred = np.load(f"{run_dir}/pred_mat_gen.npy")
    assert pred.shape == (400, 4) and np.isfinite(pred).all()
    with open(tmp / "ens.yml", "w") as f:
        yaml.dump({"method": "ensemble", "dir_emb_mat": {"ppr": [run_dir]},
                   "architecture": {"dim": 8, "act": "leakyrelu",
                                    "loss": "softmax"},
                   "hyperparameter": {"lr": 0.01, "batch_size": 32, "end": 3,
                                      "dropout": 0.0},
                   "repeat_per_emb": 2}, f)
    r = _cli(tmp, "--postproc_configs", str(tmp / "ens.yml"))
    assert "post-ensemble test: mean" in r.stdout and "over 2 runs" in r.stdout
    assert np.load(f"{run_dir}/emb_mat_0.npy").shape == (400, 16)


def test_postproc_dir_and_n_shards_refused(run):
    """``--postproc_dir`` adds the run to an empty ``dir_pred_mat``; with
    ``n_shards: 2`` the C&S driver spawns 2 ranks for the
    edge-partitioned propagation and gets the single run's accuracies
    (the propagation agrees to ~1e-6, tests/test_torch_edgepart.py)."""
    tmp, run_dir, _ = run
    accs = []
    for shards in (0, 2):
        with open(tmp / "cs2.yml", "w") as f:
            yaml.dump({"method": "cs", "dir_pred_mat": [],
                       "hyperparameter": {"norm_sym": True, "alpha": 0.7,
                                          "n_shards": shards}}, f)
        r = _cli(tmp, "--postproc_configs", str(tmp / "cs2.yml"),
                 "--postproc_dir", run_dir)
        assert "C&S acc" in r.stdout
        accs.append([ln for ln in r.stdout.splitlines() if "C&S acc" in ln])
    assert accs[0] == accs[1]


def test_compute_complexity_only(run):
    tmp, run_dir, _ = run
    r = _cli(tmp, "--inference_dir", run_dir, "--compute_complexity_only",
             "--inference_budget", "32")
    cost = re.search(r"Average inference cost per node: \[ valid  \]\s+([0-9.]+)G",
                     r.stdout)
    assert cost and float(cost.group(1)) >= 0
    assert "FINAL SUMMARY" not in r.stdout


@pytest.mark.parametrize("flags, task, path", [
    (["--configs", "a.yml"], "train", "a.yml"),
    (["--configs", "a.yml", "--compute_complexity_only"], "train", "a.yml"),
    (["--postproc_configs", "cs.yml"], "postproc", None),
    (["--postproc_configs", "cs.yml", "--inference_configs", "a.yml",
      "--reload_model_dir", "r"], "inference", "a.yml"),
    (["--inference_configs", "a.yml", "--compute_complexity_only"], "inference",
     "a.yml")])
def test_cli_task_dispatch(flags, task, path):
    """JAX's dispatch: inference before post-processing before training
    (the parsed arguments only)."""
    from shadow_gnn_torch.main import parse_args
    args = parse_args(["--dataset", "toy"] + flags)
    assert (args.task, args.config_path) == (task, path)


@pytest.mark.parametrize("flags, msg", [
    ([], "give --configs"),
    (["--inference_dir", "/nonexistent/run"], "not a directory"),
    (["--inference_configs", "a.yml"], "--reload_model_dir")])
def test_cli_task_refusals(flags, msg, capsys):
    from shadow_gnn_torch.main import parse_args
    with pytest.raises(SystemExit) as exc:
        parse_args(["--dataset", "toy"] + flags)
    assert exc.value.code == 2 and msg in capsys.readouterr().err


def test_cli_inference_dir_needs_one_yml(tmp_path, capsys):
    from shadow_gnn_torch.main import parse_args
    for name in ("a.yml", "b.yaml"):
        (tmp_path / name).write_text("{}")
        if name == "a.yml":
            args = parse_args(["--dataset", "toy", "--inference_dir", str(tmp_path)])
            assert args.config_path == f"{tmp_path}/a.yml"
    with pytest.raises(SystemExit):
        parse_args(["--dataset", "toy", "--inference_dir", str(tmp_path)])
    assert "exactly one yml" in capsys.readouterr().err
