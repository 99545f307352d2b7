"""A link-task cell added as files alone: a throwaway configuration
(SAGE, ``ppr_st`` scopes, the DRNL augment, concat residue, sort-k
pooling, sigmoid loss), its reference module and its entry, whose
``stats`` gives the mean subgraph, in a copy of the benchmark.  The
copy's own harness runs it on the CPU, and no file that the copy took
from the tree differs from the tree's."""
import contextlib
import hashlib
import importlib
import json
import math
import os
import sys
import time

from benchmark.tests.conftest import ROOT, checkout

CELL = "link_toy.train"
SEED = 2**31 + 41

LINK_CFG = {
    "name": "link_toy", "source": "throwaway", "reference": "link_toy", "dataset": "collab",
    "data": {"task": "link", "num_nodes": 400, "num_edges": 3200, "num_feat": 8,
             "num_classes": 4, "edge_split": [256, 64, 64], "eval_negatives": 64,
             "transductive": True, "degree_exponent": 0},
    "trainer": {"packed_adj": True, "use_device_ppr": True, "matmul_precision": "float32"},
    "train_config": {
        "data": {"to_undirected": True, "transductive": True},
        "architecture": {"dim": 16, "aggr": "sage", "loss": "sigmoid", "num_layers": 2,
                         "act": "elu", "feature_augment": "drnls",
                         "feature_augment_ops": "concat", "residue": "concat",
                         "pooling": "sort-8"},
        "hyperparameter": {"end": 1, "lr": 1e-3, "dropout": 0.25, "dropedge": 0.1,
                           "batch_size": 16,
                           "percent_per_epoch": {"train": 0.25, "valid": 1, "test": 1}},
        "sampler": [{"method": "ppr_st", "phase": "train", "k": [12], "threshold": [0.01],
                     "epsilon": [1e-6]}]}}

# The parameters' names and shapes alone: enough for gen.make_weights.
REFERENCE = '''"""Throwaway reference of a tiny link configuration."""
DRNL_DIM = 26


def param_specs(cfg):
    arch = cfg["train_config"]["architecture"]
    dim, layers = arch["dim"], arch["num_layers"]
    k = int(arch["pooling"].split("-")[1])
    wide = dim * layers
    lin = lambda name, out, fan: [(name + ".weight", (out, fan), "linear"),
                                  (name + ".bias", (out,), f"linear:{fan}")]
    specs = lin("aug.drnls", dim, DRNL_DIM)
    f_in = cfg["data"]["num_feat"] + dim
    for i in range(layers):
        specs += [(f"convs.{i}.scale", (2, dim), "ones"),
                  (f"convs.{i}.offset", (2, dim), "zeros")]
        specs += lin(f"convs.{i}.lin_self", dim, f_in) + lin(f"convs.{i}.lin_neigh", dim, f_in)
        f_in = dim
    specs += [("res_pool.scale", (dim,), "ones"), ("res_pool.offset", (dim,), "zeros")]
    specs += lin("res_pool.nn_pool", wide, k * wide) + lin("res_pool.lin", dim, 2 * wide)
    return specs + lin("classifier.0.lin", 1, dim)
'''

# Trainer.run_epoch over the TRAIN positives and their drawn negatives;
# the mean subgraph: the union of both ends' top-k scopes.
ENTRY = '''"""Throwaway entry: run_epoch(e, TRAIN) on the link task."""
import math

import torch

from benchmark.reference import ppr, subgraph
from benchmark.verify import TRAIN

FORWARDS_PER_ROOT = 3.0
STATS_CALLS = []


class Driver:
    def __init__(self, tr, cell, weights, split):
        self.tr, self.steps, self.losses = tr, 0, []
        orig = tr.step_graphs.run

        def run(key, deps, fn):
            out = orig(key, deps, fn)
            if key[0] == "train":
                self.steps += 1
                self.losses.append(float(out[0]))
            return out
        tr.step_graphs.run = run
        tr.run_epoch(0, TRAIN)

    def unit(self, e):
        before = self.steps
        self.tr.run_epoch(e, TRAIN)
        steps = self.steps - before
        return steps * self.tr.batch_size, steps

    def collect(self):
        return {"losses": self.losses}


def end_to_end(out):
    return {"train_subg_per_s": out["roots"] / out["window_s"]}


def judge(ref, out):
    bad = not all(math.isfinite(x) for x in out["program"]["losses"])
    return {"loss_not_finite": float(bad)}, {}, None


def control(ref, out, fault, want=None):
    raise NotImplementedError("throwaway")


def stats(ref, seed):
    STATS_CALLS.append(seed)
    pairs = ref.data["edge_set"][TRAIN]["pos"][:ref.cell["check"]["stats_roots"]]
    g, p_t = ref.graph(TRAIN)
    neighs, _ = ppr.topk_tables(p_t, pairs.reshape(-1), ref.k, ref.alpha)
    ends = torch.as_tensor(pairs, device=ref.device)
    scope = torch.cat([ends[:, 1:], neighs.view(len(pairs), -1)], 1)
    nodes = subgraph.node_tables(ends[:, 0], scope, ref.n, -(-(2 * ref.k + 2) // 8) * 8)
    adj = subgraph.induce(g["keys"], nodes, ref.n)
    return {"nodes": float((nodes < ref.n).sum(1).float().mean()),
            "edges": float(adj.sum((1, 2)).mean())}
'''

ADDED = {
    "benchmark/configs/link_toy.json": json.dumps(LINK_CFG),
    "benchmark/reference/link_toy.py": REFERENCE,
    "benchmark/entries/link_epochs.py": ENTRY,
    "benchmark/traffic/link_train.json": json.dumps(
        {"entry": "link_epochs", "why": "throwaway"}),
    "benchmark/workloads/link_toy.train.json": json.dumps(
        {"stats_roots": 16, "limits": {"loss_not_finite": 0.0}}),
    "benchmark/metrics/subgraph_nodes.py":
        "def read(ctx):\n    sub = ctx.get('subgraph')\n    return sub['nodes'] if sub else None\n",
}


def _link_checkout(tmp_path) -> str:
    root = checkout(
        tmp_path,
        configs=[{"name": "link_toy", "source": "throwaway",
                  "file": "benchmark/configs/link_toy.json", "reduced": [],
                  "why": "throwaway"}],
        workloads=[{"name": CELL, "config": "link_toy", "traffic": "link_train",
                    "chips": 1, "why": "throwaway"}],
        per_layer=[{"name": "subgraph_nodes.link", "unit": "nodes", "better": "higher",
                    "source": "program_counter", "layer": "sampling",
                    "moves": "train_subg_per_s", "workloads": [CELL]}],
        files=ADDED)
    # the cell reports the training cells' rate, as a later change adds it
    path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(path, encoding="utf-8"))
    next(m for m in spec["end_to_end"] if m["name"] == "train_subg_per_s")["workloads"].append(
        CELL)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    return root


def _is_benchmark(name: str) -> bool:
    return name == "benchmark" or name.startswith("benchmark.")


@contextlib.contextmanager
def _copy_harness(root: str):
    """The copy's ``benchmark`` package in place of the tree's while the
    block runs; the tree's back after it."""
    saved = {k: v for k, v in sys.modules.items() if _is_benchmark(k)}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        harness = importlib.import_module("benchmark.harness")
        assert harness.__file__.startswith(root)
        yield harness
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if _is_benchmark(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_link_checkout_takes_the_tree_unedited(tmp_path):
    """Every file of the copy's ``benchmark/`` is the tree's, byte for
    byte, or one that the link cell adds."""
    root = _link_checkout(tmp_path)
    copied = set()
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            if rel in ADDED:
                continue
            copied.add(rel)
            assert _sha(os.path.join(root, rel)) == _sha(os.path.join(ROOT, rel)), rel
    assert {"benchmark/gen.py", "benchmark/runner.py", "benchmark/harness.py",
            "benchmark/verify.py", "benchmark/entries/train_epochs.py"} <= copied


def test_link_cell_runs_from_files_alone(tmp_path):
    root = _link_checkout(tmp_path)
    with _copy_harness(root) as harness:
        cell = harness.load_cell(CELL, root)
        assert {m["name"] for m in cell["end_to_end"]} == {"train_subg_per_s", "setup_s"}
        res = harness.run(CELL, SEED, 0.3, False, time.time(), device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"train_subg_per_s", "setup_s"}
    assert res["metrics"]["train_subg_per_s"]["value"] > 0


def test_link_cell_stats_from_its_entry(tmp_path):
    """A traced run's mean subgraph is the entry's ``stats``: the union
    of two scopes, more nodes than one scope of k + 1 holds."""
    root = _link_checkout(tmp_path)
    with _copy_harness(root) as harness:
        seen = {}
        assemble = harness.assemble

        def keep(cell, out, checks, traced, device, end_to_end, metrics_extra=None):
            seen.update(metrics_extra)
            return assemble(cell, out, checks, traced, device, end_to_end, metrics_extra)
        harness.assemble = keep
        res = harness.run(CELL, SEED, 0.3, True, time.time(), device="cpu", root=root)
        entry = sys.modules["benchmark.runner"].entry_module(harness.load_cell(CELL, root))
        assert entry.STATS_CALLS == [SEED]
    assert res["attempted"] > 0
    sub = seen["subgraph"]
    assert 13 < sub["nodes"] <= 26 and sub["edges"] > 0 and math.isfinite(sub["edges"])
