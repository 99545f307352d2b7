"""The benchmark's own tests (run by hand: ``python -m pytest
benchmark/tests``).  ``card`` marks a test that needs a CUDA card; it
decides inside the test, through the ``card`` fixture, and skips here."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# sizes a CPU run holds: every width cut, the shapes' kinds kept
SMALL = {
    "sage3_flickr": {"config": {
        "data": {"num_nodes": 600, "num_edges": 4800, "num_feat": 32,
                 "split": [300, 150, 150]},
        "train_config": {"architecture": {"dim": 16},
                         "sampler": [{"method": "ppr", "phase": "train", "k": [16],
                                      "epsilon": [1e-6]}],
                         "hyperparameter": {"batch_size": 16}}},
        "check": {"rows": 64, "stats_roots": 64}},
    "gat5_products": {"config": {
        "data": {"num_nodes": 800, "num_edges": 8000, "num_feat": 16, "num_classes": 5,
                 "split": [200, 100, 500]},
        "label_inputs": 10,
        "train_config": {"architecture": {"dim": 16, "heads": 2},
                         "sampler": [{"method": "full", "phase": "preprocess"},
                                     {"method": "ppr", "phase": "train", "k": [16],
                                      "epsilon": [1e-6]}],
                         "hyperparameter": {"batch_size": 16}}},
        "check": {"rows": 64, "stats_roots": 64}},
}


def small(cell: str):
    return SMALL[cell.split(".")[0]]


def checkout(tmp_path, workloads=(), end_to_end=(), per_layer=(), files=None,
             configs=()) -> str:
    """A copy of the benchmark (``BENCHMARK.json`` and ``benchmark/``,
    its tests left out) with configurations, cells, metrics and files
    added, as a later change would add them; its root."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        spec = json.load(f)
    spec["configs"] += list(configs)
    spec["workloads"] += list(workloads)
    spec["end_to_end"] += list(end_to_end)
    spec["per_layer"] += list(per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for rel, text in (files or {}).items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return str(root)


def dp4_checkout(tmp_path) -> str:
    """A throwaway four-rank cell, ``sage3_flickr.train_dp4``
    (``--partition dp``, one rank a card; gloo ranks on the CPU)."""
    limits = json.load(open(os.path.join(ROOT, "benchmark", "workloads",
                                         "sage3_flickr.train.json")))
    return checkout(
        tmp_path,
        workloads=[{"name": "sage3_flickr.train_dp4", "config": "sage3_flickr",
                    "traffic": "train_dp4", "chips": 4, "why": "throwaway"}],
        end_to_end=[{"name": "train_subg_per_s.dp4", "unit": "subgraphs/s",
                     "better": "higher", "bound": 0.25, "source": "host_clock",
                     "workloads": ["sage3_flickr.train_dp4"]}],
        files={"benchmark/traffic/train_dp4.json": json.dumps(
                   {"entry": "train_epochs", "world": 4, "partition": "dp",
                    "why": "throwaway"}),
               "benchmark/workloads/sage3_flickr.train_dp4.json": json.dumps(limits)})


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
