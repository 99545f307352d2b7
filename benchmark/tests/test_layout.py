"""The harness finds configurations, traffic, entries, cells and metric
readers by name, from files alone, and a later change adds a cell, a
traffic entry and an end-to-end metric by adding files."""
import json
import os
import time

import pytest

from benchmark import harness, runner
from benchmark.tests.conftest import ROOT, checkout, small

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.load_cell(cell)
    assert c["config"]["name"] == c["workload"]["config"]
    entry = runner.entry_module(c)
    for name in ("Driver", "end_to_end", "judge", "control", "FORWARDS_PER_ROOT",
                 "STATS_MODE"):
        assert hasattr(entry, name), name
    assert set(c["check"]["limits"])
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(harness.reader(c["metrics_dir"], m["name"]))


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and m["bound"] <= 0.25
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(
            os.path.join(ROOT, c["file"]))
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_harness_names_no_entry():
    """The kinds of traffic live in ``entries/`` alone."""
    for f in ("harness.py", "runner.py", "verify.py", "run.py", "control.py"):
        text = open(os.path.join(ROOT, "benchmark", f), encoding="utf-8").read()
        assert "train_epochs" not in text, f


# A traffic entry that no file of the benchmark knows: requests of ids
# from TEST through ``Trainer.predict_nodes``, judged against the
# reference's probabilities, with its own end-to-end metric (a tail).
SERVE = '''"""Throwaway entry: requests through Trainer.predict_nodes."""
import time

import numpy as np
import torch

from benchmark.verify import TEST

FORWARDS_PER_ROOT = 1.0
STATS_MODE = TEST


class Driver:
    def __init__(self, tr, cell, weights, split):
        self.tr, self.sizes = tr, cell["traffic"]["sizes"]
        self.pool = np.asarray(tr.entity_set[TEST])
        self.rng = np.random.default_rng(0)
        self.lat, self.answers = [], []
        for s in sorted(set(self.sizes)):
            tr.predict_nodes(self.pool[:s], TEST)

    def unit(self, e):
        for s in self.sizes:
            ids = self.rng.choice(self.pool, size=s, replace=False)
            t = time.perf_counter()
            probs = self.tr.predict_nodes(ids, TEST)
            self.lat.append(time.perf_counter() - t)
            self.answers.append((ids, probs))
        return sum(self.sizes), len(self.sizes)

    def collect(self):
        return {"answers": self.answers[:4], "lat": self.lat}


def end_to_end(out):
    return {"serve_p95_ms": 1e3 * float(np.percentile(out["program"]["lat"], 95))}


def judge(ref, out):
    gap = 0.0
    with torch.no_grad():
        for ids, probs in out["program"]["answers"]:
            sub = ref.subgraphs(TEST, ids)
            want = torch.softmax(ref.model.forward(ref.w0, sub, ref.feat, ref.cfg, False), -1)
            gap = max(gap, float((torch.as_tensor(probs) - want).abs().max()))
    return {"prob_gap": gap}, {}, None


def control(ref, out, fault, want=None):
    raise NotImplementedError("throwaway")
'''


def _serve_checkout(tmp_path):
    return checkout(
        tmp_path,
        workloads=[{"name": "sage3_flickr.serve", "config": "sage3_flickr",
                    "traffic": "serve", "chips": 1, "why": "throwaway"}],
        end_to_end=[{"name": "serve_p95_ms", "unit": "ms", "better": "lower",
                     "bound": 0.05, "source": "host_clock",
                     "workloads": ["sage3_flickr.serve"]}],
        per_layer=[{"name": "requests_per_unit.serve", "unit": "requests",
                    "better": "higher", "source": "program_counter", "layer": "epoch loop",
                    "moves": "serve_p95_ms", "workloads": ["sage3_flickr.serve"]}],
        files={"benchmark/entries/serve_requests.py": SERVE,
               "benchmark/traffic/serve.json": json.dumps(
                   {"entry": "serve_requests", "sizes": [1, 8, 32, 1, 2],
                    "why": "throwaway"}),
               "benchmark/workloads/sage3_flickr.serve.json": json.dumps(
                   {"stats_roots": 32, "limits": {"prob_gap": 1e-5}}),
               "benchmark/metrics/requests_per_unit.py":
                   "def read(ctx):\n    return ctx['steps'] / ctx['units']\n"})


def test_added_cell_from_files_alone(tmp_path):
    """A throwaway cell with a new traffic entry, end-to-end metric and
    metric reader, added as files, runs with no code changed."""
    root = _serve_checkout(tmp_path)
    cell = harness.load_cell("sage3_flickr.serve", root)
    assert [m["name"] for m in cell["per_layer"]] == ["requests_per_unit.serve"]
    assert {m["name"] for m in cell["end_to_end"]} == {"serve_p95_ms", "setup_s"}
    res = harness.run("sage3_flickr.serve", 12345, 0.2, False, time.time(), device="cpu",
                      overrides=small("sage3_flickr"), root=root)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"serve_p95_ms", "setup_s"}
    assert res["metrics"]["serve_p95_ms"]["value"] > 0


def test_added_cell_catches_an_altered_answer(tmp_path, monkeypatch):
    from benchmark.tests import faults
    from shadow_gnn_torch.train import pipeline
    monkeypatch.setattr(pipeline, "predict_fn", pipeline.predict_fn)
    res = harness.run("sage3_flickr.serve", 12346, 0.2, False, time.time(), device="cpu",
                      overrides=small("sage3_flickr"), patch=faults.altered_answer,
                      root=_serve_checkout(tmp_path))
    assert not res["correct"], res["checks"]
