"""The check fails a run whose timed path is broken underneath: the
harness runs on the CPU (its look for a card skipped) with each fault
that the cell can have planted in the program."""
import json
import os
import time

import pytest

from benchmark import harness
from benchmark.tests import faults
from benchmark.tests.conftest import ROOT, dp4_checkout, small

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
TRAIN_FAULTS = [faults.unchanged_step, faults.half_batch, faults.stale_epoch]
CASES = [(c, f) for c in CELLS for f in TRAIN_FAULTS] + [
    ("sage3_flickr.train_dp4", f) for f in TRAIN_FAULTS + [faults.no_exchange]]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault, monkeypatch, tmp_path):
    import torch
    from shadow_gnn_torch.parallel import partition
    from shadow_gnn_torch.train import pipeline
    # the in-process runs: the patch is undone after the test
    for mod, name in ((torch.optim.Adam, "step"), (pipeline, "weighted_loss_fn"),
                      (partition, "spmd_weighted_loss"), (partition, "all_reduce_grads"),
                      (pipeline.Trainer, "_epoch_arrays")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    root = dp4_checkout(tmp_path) if cell.endswith("_dp4") else ROOT
    res = harness.run(cell, 2**31 + 33, 0.3, False, time.time(), device="cpu",
                      overrides=small(cell), patch=fault, root=root)
    assert not res["correct"], res["checks"]
