"""PyTorch port, the compiled partitioned step.

Each partition's step (``parallel/partition.py:make_step``, built by
``parallel/dp.py``, ``make_sharded_train_step`` and
``parallel/edgepart.py``) is a function of static buffers that a Trainer
whose process group is NCCL captures in a CUDA graph with its
collectives.  Here the ranks are 4 gloo processes on the CPU
(``parallel/launch.py:spawn``, one torch thread each, one spawn for every
check), each holding two Trainers of one seed for ``dp`` (packed, its
TRAIN cache gathered), ``feat`` and ``edge``: one with stub graphs that
do what a CUDA graph does (a capture runs nothing; a replay runs the
step and writes its outputs into the captured ones), passed through
``Trainer._run_partition`` (``StepGraphs.run``, buffers reused across
batches); the other calling the static step on fresh tensors a batch.
Checked, bit for bit: two TRAIN passes and a VALID pass (per-batch
losses, predictions, the overflow), then the parameters and Adam's
state; every step but the first of its key replays; the collectives'
calls and bytes of a graphed pass equal the fresh pass's (credited per
replay).  The static TRAIN and eval steps of each partition read no
device value on the host (no ``_local_scalar_dense``), with the BFS in a
fixed number of levels standing in for the kernel.  A gloo group and
the CPU print that every step runs eagerly.  Leaving the group
destroys every captured graph first (an NCCL communicator waits for the
graphs that hold its collectives).
"""
import os
import pickle

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from shadow_gnn_torch import TRAIN, VALID
from shadow_gnn_torch.parallel import collectives as cc
from shadow_gnn_torch.parallel import launch
from shadow_gnn_torch.parallel import multihost as mh
from shadow_gnn_torch.train import graphs

WORLD = 4
PARTS = ("dp", "feat", "edge")
GRAPH = dict(num_nodes=300, avg_deg=6, num_feat=8, num_classes=4, seed=0)
CFG = {
    "data": {"to_undirected": True, "transductive": True},
    "architecture": {"dim": 16, "aggr": "sage", "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 1e-2, "dropout": 0.2, "dropedge": 0.1,
                       "batch_size": 16},
    "sampler": [{"method": "ppr", "phase": "train", "k": [8], "epsilon": [1e-5]}],
}
PASSES = ((TRAIN, True), (TRAIN, True), (VALID, False))


# ---------------------------------------------------------------------------
# stub graphs (torch only: the ranks import this module)
# ---------------------------------------------------------------------------

def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class _Replay:
    """A captured step: each replay runs it and writes its outputs into
    the captured ones; the counts it adds in Python are taken back
    (``StepGraphs.run`` credits the capture's)."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        counters = graphs.launch_counters()
        before = graphs.counter_values(counters)
        _copy_into(self.outputs, self.fn())
        graphs.take_delta(counters, before)

    def reset(self):
        self.fn = self.outputs = None


def stub_graphs(tr):
    """``tr``'s step graphs on, with stubs that behave as CUDA graphs do:
    the warm-up runs the step; a capture leaves the parameters, Adam's
    state, every static buffer and both registered generators as it
    found them."""
    sg = tr.step_graphs
    sg.enabled = True
    sg.generator, sg.sampler = torch.Generator(), torch.Generator()

    def record(fn):
        state = [p.detach() for p in tr.model.parameters()] + [
            t for st in tr.optimizer.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)] + [
            t for buf in sg.buffers.values() for t in buf.values()]
        saved = [t.clone() for t in state]
        gens = [g.get_state() for g in (sg.generator, sg.sampler)]
        outputs = fn()
        for t, v in zip(state, saved):
            t.copy_(v)
        for g, st in zip((sg.generator, sg.sampler), gens):
            g.set_state(st)
        return _Replay(fn, outputs), outputs

    sg._warm = lambda fn: fn()
    sg._record = record


class _NoHostReads(TorchDispatchMode):
    """Raises on a read of a tensor's value on the host (``int()``,
    ``bool()``, ``.item()``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a device value was read on the host")
        return func(*args, **(kwargs or {}))


def _bfs_levels(adj, starts, node_mask):
    """The BFS in N - 1 levels, with no read of the frontier: what the
    kernel computes, without its early stop."""
    n = adj.shape[1]
    frontier = torch.arange(n)[None, None, :] == starts[..., None]
    dist = torch.where(frontier, 0, -1)
    for lvl in range(n - 1):
        new = (torch.bmm(frontier.float(), adj) > 0) & (dist < 0) & node_mask[:, None]
        dist = torch.where(new, lvl + 1, dist)
        frontier = new
    return dist


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _trainer(part):
    from shadow_gnn_torch.data import make_synthetic_dataset
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer
    tr = Trainer("toy", "", make_synthetic_dataset(**GRAPH), parse_config(CFG),
                 seed=0, device="cpu", use_device_ppr=False, partition=part,
                 partition_devices=WORLD, packed_adj=part == "dp")
    tr.profiler.enabled = False
    return tr


def _fresh_buf(tr, cols, roots, rows, labels, w, seed=None):
    buf = {"roots": torch.as_tensor(roots[cols].astype(np.int64)),
           "rows": torch.as_tensor(rows[cols].astype(np.int64)),
           "labels": torch.as_tensor(labels[cols].astype(np.int64)),
           "w": torch.as_tensor(w[cols])}
    if seed is not None:
        buf["seed"] = torch.tensor(seed, dtype=torch.int64)
    return buf


def _fresh_pass(tr, mode, train, nb, roots, rows, labels, w, seed):
    """The pass of ``Trainer._run_partition`` with the static step called
    on fresh tensors a batch and the epoch's generators themselves."""
    from shadow_gnn_torch.train.pipeline import EpochRNG, rank_seed
    step = tr._partition_step(mode, train)
    b, sl = tr.batch_size, mh.process_slice(tr.batch_size)
    rng = EpochRNG.from_seed(rank_seed(seed, mh.rank()), tr.device)
    tr.model.train(train)
    losses, preds, ovf = [], [], 0
    for i in range(nb):
        cols = slice(i * b + sl.start, i * b + sl.stop)
        s = (rng.dropedge_seed() if tr.model_cfg.dropedge > 0.0 else 0) if train else None
        out = step(_fresh_buf(tr, cols, roots, rows, labels, w, s), rng.dropout,
                   rng.sample)
        losses.append(out[0])
        preds.append(out[1])
        ovf += int(out[2])
    tr.model.eval()
    if train:
        tr.check_replicas()
    return torch.stack(losses).numpy(), torch.cat(preds).numpy(), ovf


def _state(tr):
    out = {f"param/{k}": v.numpy().copy() for k, v in tr.model.state_dict().items()}
    for k, st in tr.optimizer.state_dict()["state"].items():
        for n, v in st.items():
            out[f"adam/{k}/{n}"] = torch.as_tensor(v).numpy().copy()
    return out


def _host_reads(tr, mode, train, roots, rows, labels, w):
    """'' when the static step of (mode, train) reads no device value on
    the host, else the error.  Adam's update is left out of the check:
    on the CPU, where torch refuses ``capturable``, it keeps its step
    count on the host; on a card it is capturable and reads nothing."""
    from shadow_gnn_torch.sampling import induction
    step = tr._partition_step(mode, train)
    sl = mh.process_slice(tr.batch_size)
    buf = _fresh_buf(tr, sl, roots, rows, labels, w, 5 if train else None)
    gen, sampler = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    real = induction.bfs_hops_multi
    induction.bfs_hops_multi = _bfs_levels
    updates = []
    tr.optimizer.step = lambda: updates.append(1)
    tr.model.train(train)
    try:
        with _NoHostReads():
            step(buf, gen, sampler)
        return "" if len(updates) == int(train) else f"{len(updates)} updates"
    except AssertionError as err:
        return str(err)
    finally:
        induction.bfs_hops_multi = real
        del tr.optimizer.step
        tr.model.eval()


def rank_checks(out_dir):
    """One rank: for each partition a graphed (stub) and a fresh-step
    Trainer through the passes of PASSES, the collectives' counts, the
    replays, the plans, the host reads; writes
    ``rank<r>.pkl``."""
    out = {}
    for part in PARTS:
        graphed, fresh = _trainer(part), _trainer(part)
        stub_graphs(graphed)
        res = {"plan": fresh._graph_plan(), "passes": [], "stats": [], "keys": []}
        for mode, train in PASSES:
            got = []
            for tr in (graphed, fresh):
                tr._ensure_tables(mode)
                tr._ensure_caches(mode)
                nb, roots, rows, labels, w = tr._epoch_arrays(mode)
                seed = int(tr.rng_np.integers(1 << 31))
                cc.reset_stats()
                if tr is graphed:
                    losses, preds, ovf = tr._run_partition(mode, train, nb, roots, rows,
                                                           labels, w, seed)
                    got.append((losses, preds, int(ovf)))
                else:
                    got.append(_fresh_pass(tr, mode, train, nb, roots, rows, labels,
                                           w, seed))
                res["stats"].append((cc.stats["calls"], cc.stats["bytes"]))
            res["passes"].append((nb, got))
            step = graphed._partition_step(mode, train)
            res["keys"].append(("ptrain" if train else "peval", mode,
                                graphed.batch_size // WORLD, step.sig()))
        sg = graphed.step_graphs
        res["replays"] = dict(sg.replays)
        res["warmups"] = dict(sg.warmups)
        res["state"] = (_state(graphed), _state(fresh))
        res["host_reads"] = {
            name: _host_reads(fresh, mode, train, *fresh._epoch_arrays(mode)[1:])
            for name, mode, train in (("train", TRAIN, True), ("eval", VALID, False))}
        out[part] = res
    with open(os.path.join(out_dir, f"rank{mh.rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partition_graphs")
    launch.spawn(rank_checks, WORLD, "cpu", (str(tmp),), threads=1)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", PARTS)
def test_graphed_pass_equals_fresh_static_steps(ranks, part):
    for res in (r[part] for r in ranks):
        for nb, (got, want) in res["passes"]:
            assert len(got[0]) == nb
            for g, w_ in zip(got, want):
                np.testing.assert_array_equal(g, w_)
        s_g, s_f = res["state"]
        assert s_g.keys() == s_f.keys() and any(k.startswith("adam/") for k in s_f)
        for k in s_f:
            np.testing.assert_array_equal(s_g[k], s_f[k], err_msg=k)
    for k in ranks[0][part]["state"][0]:
        if k.startswith("param/"):
            assert all(np.array_equal(r[part]["state"][0][k], ranks[0][part]["state"][0][k])
                       for r in ranks)


@pytest.mark.parametrize("part", PARTS)
def test_every_step_but_its_keys_first_replays(ranks, part):
    for res in (r[part] for r in ranks):
        nbs = [nb for nb, _ in res["passes"]]
        train_key, _, valid_key = res["keys"]
        sig = ("cached",) if part == "dp" else ("sampled",)
        assert train_key == ("ptrain", TRAIN, 4, sig)
        assert valid_key == ("peval", VALID, 4, ("sampled",))
        assert res["replays"] == {train_key: nbs[0] + nbs[1] - 1,
                                  valid_key: nbs[2] - 1}
        assert res["warmups"] == {train_key: 1, valid_key: 1}
    assert ranks[0][part]["replays"] == ranks[1][part]["replays"]


@pytest.mark.parametrize("part", PARTS)
def test_collective_stats_are_credited_per_replay(ranks, part):
    for res in (r[part] for r in ranks):
        stats = res["stats"]
        for graphed, fresh in zip(stats[0::2], stats[1::2]):
            assert graphed == fresh and graphed[0] > 0 and graphed[1] > 0


@pytest.mark.parametrize("part", PARTS)
def test_static_steps_read_nothing_on_the_host(ranks, part):
    for res in (r[part] for r in ranks):
        assert res["host_reads"] == {"train": "", "eval": ""}


def test_gloo_and_the_cpu_run_eagerly(ranks, monkeypatch):
    """The CPU ranks print their eager path; a CUDA Trainer of a gloo
    group may not capture and says so; an NCCL group may."""
    from types import SimpleNamespace
    from shadow_gnn_torch.train.graphs import StepGraphs
    from shadow_gnn_torch.train.pipeline import Trainer, graphs_allowed
    for p in PARTS:
        assert ranks[0][p]["plan"] == (f"partition {p} over gloo (on the CPU): every "
                                       "step runs eagerly")
    assert not StepGraphs(torch.device("cpu"), True).enabled

    def plan(backend, enabled, device="cuda", partition="dp"):
        monkeypatch.setattr(mh, "backend", lambda: backend)
        fake = SimpleNamespace(partition=partition, device=torch.device(device),
                               step_graphs=SimpleNamespace(enabled=enabled), task="node")
        return Trainer._graph_plan(fake)

    assert plan("gloo", False) == "partition dp over gloo: every step runs eagerly"
    assert not graphs_allowed("dp") and graphs_allowed("none")
    assert plan("nccl", False) == ("partition dp over nccl (cuda_graphs=False): every "
                                   "step runs eagerly")
    assert graphs_allowed("edge")
    assert plan("nccl", True, partition="edge").startswith(
        "partition edge over nccl: the TRAIN and eval steps replay CUDA graphs")
    assert plan(None, False, device="cpu", partition="none") == (
        "off (on the CPU): every step runs eagerly")


def test_shutdown_destroys_the_graphs_before_the_group(monkeypatch):
    """``multihost.shutdown`` resets every captured graph, then destroys
    the process group."""
    from shadow_gnn_torch.train.graphs import StepGraphs
    order = []

    class FakeGraph:
        def replay(self):
            order.append("replay")

        def reset(self):
            order.append("reset")

    sg = StepGraphs(torch.device("cpu"), True)
    sg.enabled = True
    sg._warm = lambda fn: fn()
    sg._record = lambda fn: (FakeGraph(), fn())
    for _ in range(3):
        sg.run(("ptrain", TRAIN, 4, ("sampled",)), (), lambda: torch.zeros(1))
    assert order == ["replay", "replay"]
    monkeypatch.setattr(mh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mh.dist, "destroy_process_group", lambda: order.append("destroy"))
    mh.shutdown()
    assert order[2:] == ["reset", "destroy"] and not sg.graphs
