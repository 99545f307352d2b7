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


LINK = {"task": "link", "num_nodes": 5000, "num_edges": 40000, "num_feat": 8,
        "num_classes": 4, "edge_split": [15000, 1000, 800], "eval_negatives": 1500,
        "transductive": True, "degree_exponent": 0}


def _keys(pairs, n):
    return pairs[:, 0] * n + pairs[:, 1]


def _check_link(d, data):
    n = data["num_nodes"]
    es = d["edge_set"]
    assert d["node_set"] is None and d["indptr_train"] is None
    n_tr, n_va, n_te = data["edge_split"]
    q = data["eval_negatives"]
    assert set(es) == {0, 1, 2} and set(es[0]) == {"pos"}
    assert [es[m]["pos"].shape for m in range(3)] == [(n_tr, 2), (n_va, 2), (n_te, 2)]
    assert es[1]["neg"].shape == es[2]["neg"].shape == (q, 2)
    src = np.repeat(np.arange(n), np.diff(d["indptr"]))
    graph = set((src * n + d["indices"]).tolist())
    pos = {m: _keys(es[m]["pos"], n) for m in range(3)}
    for m in range(3):
        assert es[m]["pos"].dtype == np.int64
        assert np.all(es[m]["pos"][:, 0] < es[m]["pos"][:, 1])
    # TRAIN positives are pairs of the graph, no pair twice
    assert np.unique(pos[0]).size == n_tr and graph.issuperset(pos[0].tolist())
    # VALID / TEST positives: outside the graph, no pair twice, in either mode
    held = np.concatenate([pos[1], pos[2]])
    assert np.unique(held).size == n_va + n_te and not graph & set(held.tolist())
    every_pos = set(np.concatenate([pos[0], held]).tolist())
    for m in (1, 2):
        neg = es[m]["neg"]
        assert neg.dtype == np.int64 and np.all(neg[:, 0] != neg[:, 1])
        nk = _keys(np.sort(neg, 1), n)
        assert np.unique(nk).size == q
        assert not every_pos & set(nk.tolist()) and not graph & set(nk.tolist())


@pytest.mark.parametrize("exponent", [0, 0.75])
def test_link_draws(exponent):
    """The declared counts exactly; positives held out of the graph and
    distinct; negatives neither self loops, nor edges, nor positives;
    the same seed the same arrays."""
    data = dict(LINK, degree_exponent=exponent)
    a = gen.make_dataset(data, 2**31 + 13, "cpu")
    _check_link(a, data)
    b = gen.make_dataset(data, 2**31 + 13, "cpu")
    for m in range(3):
        for k in a["edge_set"][m]:
            assert np.array_equal(a["edge_set"][m][k], b["edge_set"][m][k])
    c = gen.make_dataset(data, 2**31 + 14, "cpu")
    assert not np.array_equal(a["edge_set"][1]["pos"], c["edge_set"][1]["pos"])


def test_link_held_out_follow_the_degrees():
    """Held-out positives take their ends in proportion to the degree:
    on the power law, their ends' mean degree is well above the graph's
    mean; the negatives' ends are uniform."""
    data = dict(LINK, degree_exponent=0.75)
    d = gen.make_dataset(data, 2**31 + 15, "cpu")
    deg = np.diff(d["indptr"])
    held = np.concatenate([d["edge_set"][1]["pos"], d["edge_set"][2]["pos"]])
    neg = np.concatenate([d["edge_set"][1]["neg"], d["edge_set"][2]["neg"]])
    assert deg[held].mean() > 3 * deg.mean()
    assert deg[neg].mean() < 1.5 * deg.mean()


def test_link_leaves_the_node_draws():
    """Stream 1 draws the same graph, features and labels for a link
    block as for a node block of the same sizes: the link arrays come
    from a stream of their own."""
    node = {k: v for k, v in LINK.items() if k not in ("task", "edge_split", "eval_negatives")}
    node["split"] = [2000, 1500, 1500]
    a = gen.make_dataset(node, 2**31 + 16, "cpu")
    b = gen.make_dataset(LINK, 2**31 + 16, "cpu")
    assert a["edge_set"] is None and a["node_set"] is not None
    for k in ("indptr", "indices", "feat", "label"):
        assert np.array_equal(a[k], b[k]), k
    _same(a, gen.make_dataset(dict(node, edge_split=[1, 1, 1], eval_negatives=1),
                              2**31 + 16, "cpu"))


def test_link_collab_split():
    """ogbl-collab's published split (1,179,052 / 60,084 / 46,329
    positives, 100,000 negatives a mode) over every pair of a graph of
    235,868 nodes."""
    data = dict(LINK, num_nodes=235868, num_edges=2 * 1179052,
                edge_split=[1179052, 60084, 46329], eval_negatives=100000)
    d = gen.make_dataset(data, 2**31 + 17, "cpu")
    es = d["edge_set"]
    assert [es[m]["pos"].shape[0] for m in range(3)] == [1179052, 60084, 46329]
    assert es[1]["neg"].shape == es[2]["neg"].shape == (100000, 2)
    n = data["num_nodes"]
    src = np.repeat(np.arange(n), np.diff(d["indptr"]))
    up = src < d["indices"]
    assert np.array_equal(_keys(es[0]["pos"], n), src[up] * n + d["indices"][up])


@pytest.mark.parametrize("change,error", [
    ({"transductive": False}, "transductive"),
    ({"edge_split": [20001, 10, 10]}, "edge_split")])
def test_link_refusals(change, error):
    with pytest.raises(ValueError, match=error):
        gen.make_dataset(dict(LINK, **change), 1, "cpu")
