"""The generator: the same seed gives the same inputs, at the published
shapes whatever the seed."""
import numpy as np
import pytest
import torch

from benchmark import gen, harness
from benchmark.reference import sage


def _same(a, b):
    for k in a:
        if isinstance(a[k], dict):
            assert all(np.array_equal(a[k][m], b[k][m]) for m in a[k])
        elif a[k] is None:
            assert b[k] is None
        else:
            assert np.array_equal(a[k], b[k]), k


def test_same_seed_same_inputs():
    data = {"num_nodes": 2000, "num_edges": 16000, "num_feat": 8, "num_classes": 5,
            "split": [1000, 500, 500], "transductive": False, "degree_exponent": 0.75}
    a = gen.make_dataset(data, 2**31 + 9, "cpu")
    _same(a, gen.make_dataset(data, 2**31 + 9, "cpu"))
    c = gen.make_dataset(data, 2**31 + 10, "cpu")
    assert not np.array_equal(a["indices"], c["indices"])
    for d in (a, c):           # every seed the same sizes
        assert d["indices"].size == 16000 and d["indptr"][-1] == 16000
        assert [d["node_set"][m].size for m in range(3)] == [1000, 500, 500]


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_flickr_published_shape(seed):
    cfg = harness.load_cell("sage3_flickr.train")["config"]
    d = gen.make_dataset(cfg["data"], seed, "cpu")
    n = 89250
    assert d["indptr"].size == n + 1 and d["indices"].size == 899756
    assert d["feat"].shape == (n, 500) and d["feat"].dtype == np.float32
    assert set(np.unique(d["label"])) == set(range(7))
    assert [d["node_set"][m].size for m in range(3)] == [44625, 22312, 22313]
    allset = np.concatenate([d["node_set"][m] for m in range(3)])
    assert np.array_equal(np.sort(allset), np.arange(n))
    # undirected, no self loops, rows ascending
    src = np.repeat(np.arange(n), np.diff(d["indptr"]))
    assert not np.any(src == d["indices"])
    key = src * n + d["indices"]
    assert np.all(np.diff(key) > 0)
    assert np.array_equal(np.sort(d["indices"].astype(np.int64) * n + src), key)
    # the inductive TRAIN graph: exactly the TRAIN-TRAIN edges
    tr = np.zeros(n, bool)
    tr[d["node_set"][0]] = True
    assert d["indices_train"].size == int((tr[src] & tr[d["indices"]]).sum())
    deg = np.diff(d["indptr"])                  # uniform: Poisson degrees
    assert deg.max() < 3 * deg.mean()


def test_flickr_power_law():
    """At ``degree_exponent`` 0.75 the largest degree is hundreds of
    times the mean (Chung-Lu at rank^-0.75: about 9,700), the hubs at
    random ids, the counts exact."""
    data = dict(harness.load_cell("sage3_flickr.train")["config"]["data"],
                degree_exponent=0.75)
    d = gen.make_dataset(data, 2**31 + 5, "cpu")
    deg = np.diff(d["indptr"])
    assert d["indices"].size == 899756 and not np.any(
        np.repeat(np.arange(89250), deg) == d["indices"])
    assert 8000 < deg.max() < 12000 and 80 <= np.percentile(deg, 99) <= 95
    assert np.argsort(deg)[-5:].min() > 100


def test_weights_from_specs():
    cfg = harness.load_cell("sage3_flickr.train")["config"]
    specs = sage.param_specs(cfg)
    w = gen.make_weights(specs, 7, "cpu")
    assert torch.equal(w["convs.0.lin_self.weight"],
                       gen.make_weights(specs, 7, "cpu")["convs.0.lin_self.weight"])
    assert float(w["convs.0.lin_self.weight"].abs().max()) <= 500 ** -0.5
    assert torch.equal(w["convs.1.scale"], torch.ones(2, 256))
    assert sum(v.numel() for v in w.values()) == sum(
        int(np.prod(s)) for _, s, _ in specs)
