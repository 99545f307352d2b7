"""PyTorch port, the spans (``shadow_gnn_torch/spans.py``).

Under ``torch.profiler`` a TRAIN epoch, an evaluation epoch (sampled:
its cache left unbuilt, so the induction's stages show) and a
``predict_nodes`` request of a tiny CPU Trainer record the spans of the
module's table, each under its documented parent, and nothing else
named ``sgnn.``; with stub graphs in place of CUDA's a step holds its
warm-up, capture or replay; no name starts with ``cu`` (the benchmark's
trace counts those as CUDA calls).  With the profiler off no range is
opened at all.  A gloo world-2 partitioned TRAIN pass records each
collective and the graphs' capture count shows a key captured again."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shadow_gnn_torch import TEST, TRAIN, VALID, spans
from shadow_gnn_torch.data import make_synthetic_dataset
from shadow_gnn_torch.parallel import launch
from shadow_gnn_torch.train.config import parse_config
from shadow_gnn_torch.train.pipeline import Trainer

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

# (span, its parent) of each kind of call; None: no span around it
EPOCH = {("sgnn.epoch", None), ("sgnn.epoch.prepare", "sgnn.epoch"),
         ("sgnn.epoch.steps", "sgnn.epoch"), ("sgnn.step", "sgnn.epoch.steps"),
         ("sgnn.stage.sample", "sgnn.step"), ("sgnn.stage.forward", "sgnn.step"),
         ("sgnn.epoch.readback", "sgnn.epoch"), ("sgnn.epoch.metrics", "sgnn.epoch")}
TRAIN_STEP = {("sgnn.stage.backward", "sgnn.step"),
              ("sgnn.stage.optimizer", "sgnn.step")}
INDUCE = {("sgnn.stage.membership", "sgnn.stage.sample"),
          ("sgnn.stage.annotate", "sgnn.stage.sample"),
          ("sgnn.stage.bfs", "sgnn.stage.annotate")}
REQUEST = {("sgnn.request", None), ("sgnn.stage.sample", "sgnn.request"),
           ("sgnn.stage.forward", "sgnn.request")}


def _trainer(**kw):
    tr = Trainer("toy", "", make_synthetic_dataset(**GRAPH), parse_config(CFG),
                 seed=0, device="cpu", use_device_ppr=False, **kw)
    tr.profiler.enabled = False
    return tr


def recorded(fn):
    """``fn()`` under torch.profiler: every span as (name, its parent's
    name: the innermost span around it on its thread, or None)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    evs = sorted(((e.start_ns(), -e.duration_ns(), e.name(), e.start_thread_id())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("sgnn.")))
    out, open_ = [], collections.defaultdict(list)
    for s, neg, name, tid in evs:
        stack = open_[tid]
        while stack and stack[-1][0] <= s:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((s - neg, name))
    return out


def test_train_epoch_records_its_spans():
    tr = _trainer()
    tr.run_epoch(0, TRAIN)
    got = recorded(lambda: tr.run_epoch(1, TRAIN))
    assert set(got) == EPOCH | TRAIN_STEP
    count = collections.Counter(name for name, _ in got)
    nb = tr._epoch_arrays(TRAIN)[0]
    assert count["sgnn.epoch"] == 1 and count["sgnn.step"] == nb
    assert count["sgnn.stage.backward"] == count["sgnn.stage.optimizer"] == nb
    # the epoch's own boundary, then its pass's
    assert count["sgnn.epoch.prepare"] == count["sgnn.epoch.readback"] == 2


def test_sampled_eval_epoch_records_the_induction():
    tr = _trainer()
    tr.disable_cache(VALID)
    got = recorded(lambda: tr.run_epoch(0, VALID))
    assert set(got) == EPOCH | INDUCE
    count = collections.Counter(name for name, _ in got)
    assert count["sgnn.stage.bfs"] == count["sgnn.step"] == tr._epoch_arrays(VALID)[0]


def test_first_epoch_profile_and_request_spans():
    tr = _trainer()
    tr.profiler.enabled = True
    got = recorded(lambda: tr.run_epoch(0, TRAIN))
    assert ("sgnn.step", "sgnn.epoch.prepare") in got      # the profile pass
    tr.prepare_serving(TEST)
    ids = np.asarray(tr.entity_set[TEST])[:5]
    got = recorded(lambda: (tr.predict_nodes(ids), tr.predict_nodes(ids)))
    assert set(got) == REQUEST
    assert [n for n, _ in got].count("sgnn.request") == 2


def test_stub_graphs_record_warmup_capture_replay():
    from test_torch_partition_graphs import stub_graphs
    tr = _trainer()
    stub_graphs(tr)
    got = recorded(lambda: tr.run_epoch(0, TRAIN))
    nb = tr._epoch_arrays(TRAIN)[0]
    graph = collections.Counter(name for name, parent in got
                                if name.startswith("sgnn.graphs.")
                                and parent == "sgnn.step")
    assert graph == {"sgnn.graphs.warmup": 1, "sgnn.graphs.capture": 1,
                     "sgnn.graphs.replay": nb - 1}
    # the stages nest in the graphs' spans (a stub's replay runs the
    # step again, where a CUDA graph's runs no Python)
    assert {p for n, p in got if n == "sgnn.stage.forward"} == {
        "sgnn.graphs.warmup", "sgnn.graphs.capture", "sgnn.graphs.replay"}
    assert tr.step_graphs.captures == {("train", TRAIN, 16, ("cached",)): 1}


def test_recapture_is_counted():
    from test_torch_partition_graphs import stub_graphs
    tr = _trainer()
    stub_graphs(tr)
    tr.run_epoch(0, TRAIN)
    key = ("train", TRAIN, 16, ("cached",))
    assert "1 captures," in tr.step_graphs.summary()
    tr.optimizer.state = collections.defaultdict(dict, tr.optimizer.state)
    tr.run_epoch(1, TRAIN)          # a new dep: warm-up and capture again
    assert tr.step_graphs.captures[key] == 2 and tr.step_graphs.warmups[key] == 2
    assert "2 captures (1 of a key captured before)" in tr.step_graphs.summary()


def test_no_span_is_a_cuda_call():
    tr = _trainer()
    names = {n for n, _ in recorded(lambda: tr.run_epoch(0, TRAIN))}
    assert names and all(n.startswith("sgnn.") and not n.startswith("cu")
                         for n in names)


def test_profiler_off_opens_no_range(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a profiler range was opened with the profiler off")

    monkeypatch.setattr(spans, "_Range", refuse)
    tr = _trainer()
    tr.run_epoch(0, TRAIN)
    tr.disable_cache(VALID)
    tr.run_epoch(0, VALID)
    tr.predict_nodes(np.asarray(tr.entity_set[TEST])[:3])
    assert spans.span("sgnn.x") is spans.span("sgnn.y", step=1)


def rank_collective_spans():
    """One gloo rank: a dp- and a feat-partitioned TRAIN pass under
    torch.profiler; for each, its spans as (name, parent), the
    collectives' counts and the pass's steps."""
    from shadow_gnn_torch.parallel import collectives as cc
    out = {}
    for part in ("dp", "feat"):
        tr = _trainer(partition=part, partition_devices=2)
        tr._ensure_tables(TRAIN)
        tr._ensure_caches(TRAIN)
        nb, roots, rows, labels, w = tr._epoch_arrays(TRAIN)
        cc.reset_stats()
        got = recorded(lambda: tr._run_partition(TRAIN, True, nb, roots, rows, labels,
                                                 w, 3))
        out[part] = got, dict(cc.stats), nb
    return out


def test_gloo_partition_records_collectives():
    parts = launch.spawn(rank_collective_spans, 2, "cpu", threads=1)
    for part, (got, stats, nb) in parts.items():
        count = collections.Counter(got)
        # one span a counted call; an asynchronous call's join and gloo's
        # staging are spans of their own, never a second call's
        calls = sum(n for (name, _), n in count.items()
                    if name.startswith("sgnn.collective.")
                    and name not in ("sgnn.collective.wait", "sgnn.collective.stage"))
        assert calls == stats["calls"] > 0 and set(stats) == {"calls", "bytes"}, part
        # a CPU tensor is not staged
        assert not any(name == "sgnn.collective.stage" for name, _ in count), part
    count = collections.Counter(parts["dp"][0])
    nb = parts["dp"][2]
    # each dp step: the loss's weight sum, the gradients, the loss, the
    # overflow (all-reduces) and the predictions (all-gather); the pass
    # then gathers the replicas' checksums
    assert count[("sgnn.collective.all_reduce", "sgnn.stage.forward")] == nb
    assert count[("sgnn.collective.all_reduce", "sgnn.stage.backward")] == nb
    assert count[("sgnn.collective.all_gather", "sgnn.step")] == nb
    assert count[("sgnn.collective.all_gather", "sgnn.epoch.readback")] == 1
    assert not any(name.startswith("sgnn.collective.reduce_scatter") for name, _ in count)
    # feat gathers its features from the row-sharded table: an all-gather
    # of the ids and a reduce-scatter of the rows, each one span
    count = collections.Counter(name for name, _ in parts["feat"][0])
    assert count["sgnn.collective.reduce_scatter"] > 0
    assert count["sgnn.collective.all_gather"] >= count["sgnn.collective.reduce_scatter"]


@pytest.mark.parametrize("name", ["sgnn.epoch", "sgnn.step"])
def test_span_args_are_kept_when_shapes_are_recorded(name):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with spans.span(name, epoch=3, step=17):
            pass
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == name]
    assert len(ev) == 1 and ev[0].kwinputs() == {"epoch": 3, "step": 17}
