"""The reference against the port at a small size on the CPU: every cell
(and a throwaway four-rank one) runs end to end and comes out correct,
its numbers at rounding."""
import json
import os
import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, dp4_checkout, small

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def _agrees(res):
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] < 1e-5, (name, c)
    assert res["attempted"] > 0 and res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees(cell):
    _agrees(harness.run(cell, 2**31 + 21, 0.3, False, time.time(), device="cpu",
                        overrides=small(cell)))


def test_reference_agrees_four_ranks(tmp_path):
    _agrees(harness.run("sage3_flickr.train_dp4", 2**31 + 21, 0.3, False, time.time(),
                        device="cpu", overrides=small("sage3_flickr"),
                        root=dp4_checkout(tmp_path)))
