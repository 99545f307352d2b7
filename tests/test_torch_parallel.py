"""PyTorch port, partitioned training (``shadow_gnn_torch/parallel``:
multihost, collectives, partition, dp) against the JAX package.

JAX runs in this process on the 8-device CPU mesh of
``tests/conftest.py`` with ``partition_devices=4``; the port runs in 4
spawned gloo ranks on the CPU (``parallel/launch.py:spawn``, one torch
thread each), whose functions below import neither JAX nor this
module's JAX side (JAX is imported inside the helpers that need it).
Each rank writes its results to ``tmp_path`` and the parent compares.

Size: JAX's ``_tiny_trainer`` (``tests/test_parallel.py``): 400 nodes,
dim 16, PPR k 8, batch 16 (15 TRAIN batches of 4 columns a rank), both
subgraph profilers off, dropout 0, dropedge 0, weights from
``params_from_flax``.  Tolerances:
* ``pad_rows_to_shards``, ``process_slice``, ``sharded_feat_gather``:
  exact (f32 and bf16 tables, sentinel ids give zero rows);
* the first TRAIN epoch under ``dp`` (packed_adj: the packed product)
  and ``feat``: per-batch losses against JAX's at rtol 1e-5;
  predictions within 1e-5 and every parameter within 1e-5 of its max
  |value| against the port's single-card epoch from the same weights,
  and within 1e-4 against JAX's (the port's single-card tolerance
  against JAX, ``tests/test_torch_train.py``: optax forms Adam's bias
  corrections in f32, and over 15 steps at lr 1e-2 the port and JAX
  drift apart by up to 3e-5 in the predictions, the first batch's
  2.4e-7); the parameters bit-equal across the ranks; the VALID stats
  after it (loss rtol 1e-5, accuracy equal);
* the tail-batch normalisation (``w`` zero beyond rank 0's rows): the
  partitioned loss equals JAX's single-device weighted loss at rtol
  1e-5.
The CLI spawns 4 ranks with ``--partition dp --partition_devices 4``,
and 4 subprocesses join through ``--distributed`` with torchrun's
variables; rank 0 alone writes the run dir.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from shadow_gnn_torch import TRAIN, VALID
from shadow_gnn_torch.parallel import launch
from shadow_gnn_torch.parallel import multihost as mh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GRAPH = dict(num_nodes=400, avg_deg=6, num_feat=8, num_classes=4, seed=0)
CFG = {
    "data": {"transductive": True},
    "architecture": {"dim": 16, "aggr": "sage", "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 1e-2, "dropout": 0.0, "dropedge": 0.0,
                       "batch_size": 16},
    "sampler": [{"method": "ppr", "phase": "train", "k": [8], "epsilon": [1e-5]}],
}
TAIL_VALID = 2            # valid rows of the tail-batch case, all on rank 0
GATHER_TAB = (1000, 16)   # the sharded_feat_gather table
GATHER_IDS = (16, 12)     # its global id block (4 rows a rank)


# ---------------------------------------------------------------------------
# the ranks (torch only)
# ---------------------------------------------------------------------------

def port_trainer(partition="none", cfg=CFG, graph=GRAPH, **kw):
    from shadow_gnn_torch.data import make_synthetic_dataset
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer
    tr = Trainer("toy", "", make_synthetic_dataset(**graph), parse_config(cfg),
                 seed=0, device="cpu", use_device_ppr=False, partition=partition,
                 partition_devices=WORLD if partition != "none" else 0, **kw)
    tr.profiler.enabled = False
    return tr


def gather_inputs():
    rng = np.random.default_rng(0)
    tab = rng.normal(size=GATHER_TAB).astype(np.float32)
    nodes = rng.integers(0, GATHER_TAB[0], size=GATHER_IDS)
    nodes[0, -2:] = GATHER_TAB[0] + 24            # beyond the padded table
    nodes[5, 0] = GATHER_TAB[0]                   # the sentinel
    return tab, nodes


def tail_batch(tr):
    """The first 16 TRAIN nodes as one batch, ``w`` zero beyond the
    first TAIL_VALID rows (all of them rank 0's)."""
    ent = np.asarray(tr.entity_set[TRAIN])[:tr.batch_size]
    w = np.zeros(tr.batch_size, np.float32)
    w[:TAIL_VALID] = 1.0
    return ent[:, None], np.arange(ent.size)[:, None], tr.label_np[ent], w


def rank_epoch(partition, state_path, out_dir, packed):
    """One rank: the checks of ``partition``, then the first TRAIN epoch
    and one VALID epoch; writes ``rank<r>.npz``."""
    from shadow_gnn_torch.parallel.partition import (make_sharded_gather_fn,
                                                     shard_table, sharded_feat_gather)
    from shadow_gnn_torch.train.pipeline import EpochRNG
    r = mh.rank()
    tr = port_trainer(partition, packed_adj=packed)
    tr.model.load_state_dict(torch.load(state_path))
    out = {"slice": np.asarray([mh.process_slice(10).start,
                                mh.process_slice(10).stop])}
    if partition == "feat":
        tab, nodes = gather_inputs()
        ids = torch.as_tensor(nodes[mh.process_slice(nodes.shape[0])])
        _, gather = make_sharded_gather_fn(tab, "cpu")
        out["gather_f32"] = gather(ids).numpy()
        out["gather_bf16"] = sharded_feat_gather(
            shard_table(tab, "cpu", torch.bfloat16), ids).float().numpy()
        # the tail batch through the evaluation form (no update)
        tr._ensure_tables(TRAIN)
        roots, rows, labels, w = tail_batch(tr)
        b = mh.process_slice(tr.batch_size)
        step = tr._partition_step(TRAIN, False)
        tr.model.eval()
        loss, _, _ = step({"roots": torch.as_tensor(roots[b]),
                           "rows": torch.as_tensor(rows[b]),
                           "labels": torch.as_tensor(labels[b]),
                           "w": torch.as_tensor(w[b])}, None,
                          EpochRNG.from_seed(0, tr.device).sample)
        out["tail_loss"] = np.asarray(float(loss))
    tr._ensure_tables(TRAIN)
    tr._ensure_caches(TRAIN)
    nb, roots, rows, labels, w = tr._epoch_arrays(TRAIN)
    seed = int(tr.rng_np.integers(1 << 31))
    losses, preds, ovf = tr._run_partition(TRAIN, True, nb, roots, rows, labels, w,
                                           seed)
    stats = tr.run_epoch(0, VALID)
    out.update(losses=losses, preds=preds, ovf=np.asarray(ovf),
               roots=roots.reshape(-1),
               valid=np.asarray([stats["loss"], stats["accuracy"]]),
               dispatches=np.asarray(tr.partition_train_dispatches))
    for k, v in tr.model.state_dict().items():
        out[f"param/{k}"] = v.numpy()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


def spawn_epoch(tmp_path, partition, state, packed):
    torch.save(state, tmp_path / "state.pt")
    launch.spawn(rank_epoch, WORLD, "cpu",
                 (partition, str(tmp_path / "state.pt"), str(tmp_path), packed),
                 threads=1)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def jax_epoch(partition, packed):
    """JAX's Trainer at ``partition_devices=4``: (the initial weights
    as a port state dict, the tail-batch loss, the first TRAIN epoch's
    losses / predictions / weights, the VALID stats after it)."""
    import jax
    import jax.numpy as jnp
    from shadow_gnn_tpu import TRAIN as J_TRAIN, VALID as J_VALID
    from shadow_gnn_tpu.data.synthetic import make_synthetic_dataset
    from shadow_gnn_tpu.train.config import parse_config
    from shadow_gnn_tpu.train.logger import Logger
    from shadow_gnn_tpu.train.metrics import Metrics
    from shadow_gnn_tpu.train.pipeline import Trainer, weighted_loss_fn
    from shadow_gnn_torch.convert import params_from_flax
    m = Metrics("toy", False, "accuracy", 1)
    jtr = Trainer("toy", "", make_synthetic_dataset(**GRAPH), parse_config(CFG), m,
                  Logger(m, "", no_log=True), seed=0, use_device_ppr=False,
                  packed_adj=packed, partition=partition, partition_devices=WORLD)
    jtr.profiler.enabled = False

    def state():
        return params_from_flax(jax.tree_util.tree_map(np.asarray, jtr.params))
    init = state()
    jtr._ensure_tables(J_TRAIN)
    jtr._ensure_caches(J_TRAIN)
    roots, rows, labels, w = tail_batch(jtr)
    batches, feats = jtr._sample_branch_batches(
        J_TRAIN, jnp.asarray(roots, jnp.int32), jnp.asarray(rows, jnp.int32),
        jax.random.PRNGKey(0), jtr._mode_arrays(J_TRAIN))
    logits, _ = jtr.model.apply(jtr.params, batches, feats, mode_train=True,
                                train=False)
    tail = float(weighted_loss_fn(jtr.model_cfg, logits,
                                  jnp.asarray(labels.astype(np.int32)),
                                  jnp.asarray(w)))
    nb, roots, rows, lab, w, _, _ = jtr._epoch_arrays(J_TRAIN)
    rng = jax.random.PRNGKey(jtr.rng_np.integers(1 << 31))
    losses, preds, _ = jtr._run_partition_epoch(J_TRAIN, nb, roots, rows, lab, w, rng)
    trained = state()
    stats = jtr.run_epoch(0, J_VALID)
    return dict(init=init, tail=tail, losses=np.asarray(losses),
                preds=np.asarray(preds).reshape(-1, preds.shape[-1]),
                roots=np.asarray(roots).reshape(-1), params=trained,
                valid=(stats["loss"], stats["accuracy"]))


def single_epoch(state, packed):
    """The port's single-card TRAIN epoch and VALID stats from ``state``
    (the same rng_np draws as a partitioned run)."""
    from shadow_gnn_torch.train.pipeline import EpochRNG
    tr = port_trainer(packed_adj=packed)
    tr.model.load_state_dict(state)
    tr._ensure_tables(TRAIN)
    tr._ensure_caches(TRAIN)
    nb, roots, rows, labels, w = tr._epoch_arrays(TRAIN)
    rng = EpochRNG.from_seed(int(tr.rng_np.integers(1 << 31)), tr.device)
    losses, preds, _ = tr._run_batches(TRAIN, True, nb, roots, rows, labels, w, rng)
    params = {k: v.clone() for k, v in tr.model.state_dict().items()}
    stats = tr.run_epoch(0, VALID)
    return dict(losses=losses, preds=preds, params=params,
                valid=(stats["loss"], stats["accuracy"]))


def _close_params(res, params, frac):
    for k, v in params.items():
        v = v.numpy()
        np.testing.assert_allclose(res[f"param/{k}"], v, rtol=0,
                                   atol=frac * max(np.abs(v).max(), 1e-30), err_msg=k)


def check_epoch(ranks, want, single):
    """Every rank against JAX and the port's single-card epoch, and the
    ranks against each other."""
    for res in ranks:
        np.testing.assert_array_equal(res["roots"], want["roots"])
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(res["losses"], single["losses"], rtol=1e-5)
        np.testing.assert_allclose(res["preds"], single["preds"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["preds"], want["preds"], rtol=0, atol=1e-4)
        _close_params(res, single["params"], 1e-5)
        _close_params(res, want["params"], 1e-4)
        for ref in (want, single):
            np.testing.assert_allclose(res["valid"][0], ref["valid"][0], rtol=1e-5)
            assert res["valid"][1] == ref["valid"][1]
        assert int(res["ovf"]) == 0 and int(res["dispatches"]) == 1
    for res in ranks[1:]:
        for k in want["params"]:
            assert np.array_equal(res[f"param/{k}"], ranks[0][f"param/{k}"]), k
        np.testing.assert_array_equal(res["preds"], ranks[0]["preds"])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(10, 3), (12, 2), (1, 5), (7,)])
def test_pad_rows_to_shards_matches_jax(shape):
    from shadow_gnn_tpu.parallel.partition import pad_rows_to_shards as j_pad
    from shadow_gnn_torch.parallel.partition import local_rows, pad_rows_to_shards
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = pad_rows_to_shards(x, WORLD)
    assert got.tobytes() == j_pad(x, WORLD).tobytes() and got.shape == j_pad(x, WORLD).shape
    for s in range(WORLD):
        nl = got.shape[0] // WORLD
        np.testing.assert_array_equal(local_rows(x, WORLD, s), got[s * nl:(s + 1) * nl])


def test_initialize_without_a_launcher(monkeypatch):
    """No launcher variables, or a world of 1 from the environment: no
    group, nothing done (JAX's rule); one rank covers the whole range."""
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    assert mh.initialize(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert mh.initialize(device="cpu") is False
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert mh.initialize(device="cpu") is False
    assert mh.world_size() == 1 and mh.process_slice(10) == slice(0, 10)


@pytest.mark.parametrize("world", [1, 2])
def test_nccl_refuses_more_ranks_than_cards(world):
    """NCCL cannot put two ranks of one group on one card: a spawn of
    more ranks than the host's cards (none here) is refused by name."""
    with pytest.raises(RuntimeError, match="more ranks than cards"):
        launch.check_cards("cuda", world)
    launch.check_cards("cuda:0", world, backend="gloo")   # gloo may share a card


def test_partitioned_trainer_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        port_trainer("dp")


def test_dp_epoch_matches_jax(tmp_path):
    """``--partition dp`` with packed_adj: every rank gathers its columns
    from the replicated cache and aggregates them through the packed
    product; JAX's dp epoch-scan program on 4 devices."""
    want = jax_epoch("dp", packed=True)
    ranks = spawn_epoch(tmp_path, "dp", want["init"], packed=True)
    check_epoch(ranks, want, single_epoch(want["init"], packed=True))
    assert [tuple(r["slice"]) for r in ranks] == [(0, 3), (3, 6), (6, 9), (9, 10)]


def test_feat_epoch_gather_and_tail_batch_match_jax(tmp_path):
    """``--partition feat``: the row-sharded feature gather (f32 and bf16
    tables, out-of-range ids give zero rows) equals JAX's
    ``make_sharded_gather_fn`` on 4 devices bit for bit; the tail
    batch's loss equals JAX's single-device loss; the TRAIN epoch and
    the VALID stats equal JAX's feat Trainer's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from shadow_gnn_tpu.parallel.partition import make_sharded_gather_fn
    want = jax_epoch("feat", packed=False)
    ranks = spawn_epoch(tmp_path, "feat", want["init"], packed=False)
    check_epoch(ranks, want, single_epoch(want["init"], packed=False))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    tab, nodes = gather_inputs()
    ids = jax.device_put(jnp.asarray(nodes.astype(np.int32)),
                         NamedSharding(mesh, P("dp", None)))
    for key, t in (("gather_f32", tab),
                   ("gather_bf16", np.asarray(jnp.asarray(tab, jnp.bfloat16)))):
        _, gather = make_sharded_gather_fn(mesh, t)
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_array_equal(got, np.asarray(gather(ids), np.float32))
        assert not got[0, -2:].any() and not got[5, 0].any()
    for r in ranks:
        np.testing.assert_allclose(float(r["tail_loss"]), want["tail"], rtol=1e-5)


def _toy_data(tmp_path):
    from shadow_gnn_torch.data import make_synthetic_dataset, save_shadow_format
    g = make_synthetic_dataset(**GRAPH)
    save_shadow_format(str(tmp_path / "data"), "toy", indptr=g.indptr_full,
                       indices=g.indices_full, feat=g.feat_full,
                       label=g.label_full, node_set=g.node_set)
    with open(tmp_path / "toy.yml", "w") as f:
        yaml.dump(CFG, f)
    return ["--configs", str(tmp_path / "toy.yml"), "--dataset", "toy",
            "--data_dir", str(tmp_path / "data"), "--log_dir", str(tmp_path / "logs"),
            "--device", "cpu", "--seed", "1"]


def _one_run_dir(tmp_path):
    runs = list((tmp_path / "logs" / "toy" / "finished").iterdir())
    assert len(runs) == 1, runs
    assert (runs[0] / "final.csv").is_file() and (runs[0] / "config.yml").is_file()
    assert list(runs[0].glob("saved_model_*.pt"))
    assert not (tmp_path / "logs" / "toy" / "running").exists() or not list(
        (tmp_path / "logs" / "toy" / "running").iterdir())


def test_cli_partition_spawns_ranks(tmp_path, capfd):
    """``--partition dp --partition_devices 4 --device cpu``: the command
    spawns 4 ranks, trains an epoch and evaluates; rank 0 alone prints
    and writes the run dir."""
    from shadow_gnn_torch import main as tmain
    argv = _toy_data(tmp_path) + ["--partition", "dp", "--partition_devices", "4",
                                  "--packed_adj"]
    assert tmain.main(argv) == 0
    out = capfd.readouterr().out
    assert out.count("FINAL SUMMARY:") == 1 and out.count("[train] ep    0") == 1
    _one_run_dir(tmp_path)


def test_cli_distributed_under_torchrun_variables(tmp_path):
    """4 processes with torchrun's variables and ``--distributed
    --partition feat``: one group, one run dir (rank 0's), every rank
    exits 0."""
    argv = _toy_data(tmp_path) + ["--distributed", "--partition", "feat"]
    port = str(mh.free_port())
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "shadow_gnn_torch.main", *argv], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, o[-2000:] + e[-2000:]
    assert "FINAL SUMMARY:" in outs[0][0]
    assert all("FINAL SUMMARY:" not in o for o, _ in outs[1:])
    _one_run_dir(tmp_path)


@pytest.mark.parametrize("flags, name", [
    (["--distributed"], "--distributed"),
    (["--partition", "dp", "--device", "cpu"], "--partition_devices"),
    (["--partition", "tp"], "--partition"),
    (["--partition", "dp", "--partition_devices", "-1"], "--partition_devices")])
def test_cli_partition_refusals(flags, name, capsys):
    from shadow_gnn_torch.main import parse_args
    with pytest.raises(SystemExit) as exc:
        parse_args(["--configs", "toy.yml", "--dataset", "toy", *flags])
    assert exc.value.code == 2 and name in capsys.readouterr().err
