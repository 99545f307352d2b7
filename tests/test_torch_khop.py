"""PyTorch port: the khop and nodeIID samplers and ``default_n_pad``.

khop is held EXACTLY against the JAX package with the JAX package's own
draws passed in (the same ``jax.random.split`` / ``randint`` calls as
``shadow_gnn_tpu/sampling/samplers.py:219-223``): node tables, and the
whole induced batch under the Trainer's khop plan.  The port's own
generator is held by a chi-square bound on the picks of one hub row."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from shadow_gnn_tpu.data.graph import DeviceGraph as JGraph
from shadow_gnn_tpu.data.synthetic import make_random_graph
from shadow_gnn_tpu.sampling import samplers as jsamp
from shadow_gnn_tpu.sampling.batch import SamplerConfig as JConfig
from shadow_gnn_tpu.sampling.batch import default_n_pad as j_n_pad
from shadow_gnn_torch.data.graph import DeviceGraph as TGraph
from shadow_gnn_torch.sampling import samplers as tsamp
from shadow_gnn_torch.sampling.batch import SamplerConfig as TConfig
from shadow_gnn_torch.sampling.batch import default_n_pad as t_n_pad

torch.set_num_threads(2)
NUM_NODES, B = 800, 16


@pytest.fixture(scope="module")
def graphs():
    indptr, indices = make_random_graph(NUM_NODES, 12.0, seed=5, power_law=True)
    return (JGraph.from_csr(indptr, indices), TGraph.from_csr(indptr, indices),
            np.diff(indptr))


def _roots(t, seed=1):
    """[B, t] roots, the hubs 0..3 among them."""
    rng = np.random.default_rng(seed)
    r = rng.choice(NUM_NODES, (B, t), replace=True)
    r[:4, 0] = np.arange(4)
    return r.astype(np.int32)


def _jax_picks(key, b, t, depth, budget):
    """The integers JAX's sample_nodes_khop draws from ``key``, one
    [B, T * budget**l, budget] array per level."""
    picks, w = [], t
    for _ in range(depth):
        key, sub = jax.random.split(key)
        picks.append(torch.as_tensor(np.array(
            jax.random.randint(sub, (b, w, budget), 0, 1 << 30))))
        w *= budget
    return picks


KHOP_CASES = [(2, 6, 1), (2, 4, 2), (3, 3, 1), (1, 5, 1)]


@pytest.mark.parametrize("depth,budget,t", KHOP_CASES)
def test_khop_matches_jax_with_its_picks(graphs, depth, budget, t):
    jg, tg, deg = graphs
    kw = dict(method="khop", depth=depth, budget=budget, num_targets=t,
              n_pad=j_n_pad({"method": "khop", "depth": depth, "budget": budget}, t))
    assert kw["n_pad"] <= 64
    roots = _roots(t)
    key = jax.random.PRNGKey(depth * 10 + budget)
    jn, js = jsamp.sample_nodes_khop(JConfig(**kw), jg, jnp.asarray(roots), key)
    tn, ts = tsamp.sample_nodes_khop(TConfig(**kw), tg, torch.as_tensor(roots).long(),
                                     picks=_jax_picks(key, B, t, depth, budget))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the hubs took budget picks, and a level of small rows took them all
    assert (deg[:4] > budget).all() and ((tn < NUM_NODES).sum(1) > budget).any()


def test_khop_batch_under_trainer_plan_matches_jax(graphs):
    """sample_subgraphs for khop (depth 2, budget 6) under the rows + hub
    plan the Trainer gives a power-law graph: the whole batch exactly."""
    jg, tg, _ = graphs
    kw = dict(method="khop", depth=2, budget=6, n_pad=48, induction="rows",
              deg_cap=128, hub_slots=8, add_self_edge=True, aug_feats=("hops",))
    roots = _roots(1, seed=4)
    key = jax.random.PRNGKey(7)
    jb = jsamp.sample_subgraphs(JConfig(**kw), jg, jnp.asarray(roots), rng=key)
    tb = tsamp.sample_subgraphs(TConfig(**kw), tg, torch.as_tensor(roots).long(),
                                picks=_jax_picks(key, B, 1, 2, 6))
    for f in ("nodes", "adj", "targets", "hop", "node_mask", "size", "ppr"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.overflow == int(jb.overflow)
    assert (tb.hop.numpy() == 2).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_khop_generator_picks_uniform(graphs, seed):
    """The port's own draws: with budget 1 a hub root's one level-1 node
    is a pick of its CSR row, uniform over the row (chi-square at
    p = 1e-4), and the same generator state gives the same picks."""
    _, tg, deg = graphs
    hub = int(np.argmax(deg))
    cfg = TConfig(method="khop", depth=1, budget=1, n_pad=8)
    roots = torch.full((8000, 1), hub)
    nodes, _ = tsamp.sample_nodes_khop(cfg, tg, roots,
                                       torch.Generator().manual_seed(seed))
    # each sorted table holds the hub and its one pick
    picked = np.where(nodes[:, 0].numpy() == hub, nodes[:, 1].numpy(),
                      nodes[:, 0].numpy())
    row = tg.indices[tg.indptr[hub]:tg.indptr[hub + 1]].numpy()
    assert np.isin(picked, row).all()
    counts = np.bincount(np.searchsorted(row, picked), minlength=row.size)
    chi2 = ((counts - picked.size / row.size) ** 2 / (picked.size / row.size)).sum()
    assert chi2 < scipy.stats.chi2.ppf(1 - 1e-4, row.size - 1), chi2
    again, _ = tsamp.sample_nodes_khop(cfg, tg, roots,
                                       torch.Generator().manual_seed(seed))
    assert torch.equal(again, nodes)


@pytest.mark.parametrize("t", [1, 2])
def test_sample_nodes_iid_matches_jax(graphs, t):
    jg, tg, _ = graphs
    roots = _roots(t, seed=3)
    roots[5, -1] = roots[5, 0]                      # a repeated target
    kw = dict(method="nodeIID", num_targets=t, n_pad=8)
    jn, js = jsamp.sample_nodes_iid(JConfig(**kw), jg, jnp.asarray(roots))
    tn, ts = tsamp.sample_nodes_iid(TConfig(**kw), tg, torch.as_tensor(roots).long())
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("cfg,t", [
    ({"method": "khop", "depth": 2, "budget": 10}, 1),     # the arxiv branch: 112
    ({"method": "khop", "depth": 3, "budget": 4}, 2),
    ({"method": "khop", "depth": 1, "budget": 20}, 1),
    ({"method": "nodeIID"}, 1),
    ({"method": "nodeIID"}, 2),
    ({"method": "ppr", "k": 200}, 1),
])
def test_default_n_pad_matches_jax(cfg, t):
    assert t_n_pad(cfg, t) == j_n_pad(cfg, t)
    if cfg.get("budget") == 10:
        assert t_n_pad(cfg, t) == 112
