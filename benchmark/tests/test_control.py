"""The control (the reference with TF32 products in the program's place)
and the half-batch fault come out as not correct; TF32 exists only on a
card.  At the cells' own size on the card: ``python benchmark/control.py``."""
import json
import os

import pytest

from benchmark import control
from benchmark.tests.conftest import ROOT, small

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, card):
    for seed in (1, 2, 3):
        res = control.readings(cell, seed, "cuda", small(cell))
        for low in ("tf32", "half_batch"):
            assert any(not v["value"] <= v["limit"] for v in res[low].values()), res
