"""PyTorch port: config parsing, the shaDow on-disk format, and the small
sampling helpers, held EXACTLY against the JAX package on the same
inputs."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.data import format as jfmt
from shadow_gnn_tpu.data import graph as jgraph
from shadow_gnn_tpu.data import loader as jloader
from shadow_gnn_tpu.sampling import batch as jbatch
from shadow_gnn_tpu.sampling import induction as jind
from shadow_gnn_tpu.sampling import samplers as jsamp
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_torch.data import format as tfmt
from shadow_gnn_torch.data import graph as tgraph
from shadow_gnn_torch.data import loader as tloader
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.sampling import batch as tbatch
from shadow_gnn_torch.sampling import induction as tind
from shadow_gnn_torch.sampling import samplers as tsamp
from shadow_gnn_torch.train.config import parse_config as t_parse

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(p for p in glob.glob(os.path.join(ROOT, "configs", "*.yml"))
                 if "TEMPLATE" not in p)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_parse_config_matches_jax(path):
    assert t_parse(path) == j_parse(path)


def _dataset(prefix, fmt, g, train_sub):
    return fmt.save_shadow_format(
        str(prefix), "toy", indptr=g.indptr_full, indices=g.indices_full,
        feat=g.feat_full, label=g.label_full, node_set=g.node_set,
        indptr_train=train_sub[0], indices_train=train_sub[1])


def _train_subgraph(g):
    """The directed adjacency among TRAIN nodes (an inductive split)."""
    keep = np.zeros(g.num_nodes, bool)
    keep[g.node_set[0]] = True
    src = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr_full))
    sel = keep[src] & keep[g.indices_full] & (src < g.indices_full)
    indptr = np.r_[0, np.cumsum(np.bincount(src[sel], minlength=g.num_nodes))]
    return indptr.astype(np.int64), g.indices_full[sel]


@pytest.mark.parametrize("to_undirected", [False, True])
@pytest.mark.parametrize("transductive", [False, True])
def test_load_data_matches_jax(tmp_path, to_undirected, transductive):
    g = t_make(num_nodes=300, avg_deg=6, num_feat=8, num_classes=4, seed=1)
    train_sub = _train_subgraph(g)
    dj = _dataset(tmp_path / "jax", jfmt, g, train_sub)
    dt = _dataset(tmp_path / "torch", tfmt, g, train_sub)
    for f in sorted(os.listdir(dj)) + ["cpp/" + f for f in os.listdir(f"{dj}/cpp")]:
        if os.path.isfile(f"{dj}/{f}"):
            with open(f"{dj}/{f}", "rb") as a, open(f"{dt}/{f}", "rb") as b:
                assert a.read() == b.read(), f
    cfg = {"to_undirected": to_undirected, "transductive": transductive}
    a = jloader.load_data(str(tmp_path / "jax"), "toy", cfg)
    b = tloader.load_data(str(tmp_path / "torch"), "toy", cfg)
    for f in ("indptr_full", "indices_full", "indptr_train", "indices_train",
              "feat_full", "label_full"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(vb, va, err_msg=f)
    for m in a.node_set:
        np.testing.assert_array_equal(b.node_set[m], a.node_set[m])
    assert b.is_transductive == a.is_transductive
    assert (tgraph.is_undirected(b.indptr_full, b.indices_full)
            == jgraph.is_undirected(a.indptr_full, a.indices_full))


@pytest.mark.parametrize("n", [1, 64, 65, 200, 208, 1000, 5000])
def test_bucket_cap_matches_jax(n):
    assert tind.bucket_cap(n) == jind.bucket_cap(n)


@pytest.mark.parametrize("cfg", [
    {"method": "ppr", "k": 200}, {"method": "ppr", "k": 16},
    {"method": "ppr_st", "k": 50}, {"method": "khop", "depth": 2, "budget": 10},
    {"method": "nodeIID"}])
@pytest.mark.parametrize("num_targets", [1, 2])
def test_default_n_pad_matches_jax(cfg, num_targets):
    assert (tbatch.default_n_pad(cfg, num_targets)
            == jbatch.default_n_pad(cfg, num_targets))


@pytest.mark.parametrize("cfg", [{"method": "full"}, {"method": "bogus"}])
def test_default_n_pad_unported_sampler_raises(cfg):
    """A method without a capacity rule raises in both packages."""
    with pytest.raises(ValueError):
        jbatch.default_n_pad(cfg)
    with pytest.raises(ValueError, match="unknown sampler"):
        tbatch.default_n_pad(cfg)


def test_hop2onehot_matches_jax():
    hop = np.array([[-1, 0, 1, 2, 5, 6, 7, 254, 255, 300]], np.int32)
    want = np.asarray(jbatch.hop2onehot(jnp.asarray(hop)))
    got = tbatch.hop2onehot(torch.as_tensor(hop).long()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_pad", [8, 16, 24, 40])
def test_dedup_with_scores_matches_jax(n_pad):
    """24 ids into n_pad slots: score-aware truncation (8, 16), an exact
    fit (24) and padding (40); duplicate ids carry different scores and
    the targets carry -1 (always kept)."""
    rng = np.random.default_rng(n_pad)
    ids = rng.integers(0, 30, (4, 24)).astype(np.int64)
    sc = rng.random((4, 24)).astype(np.float32).round(2)
    sc[:, 0] = -1.0
    sent = 50
    ids[:, -3:] = sent
    sc[:, -3:] = 0.0
    jn, js = jsamp._dedup_with_scores(jnp.asarray(ids, jnp.int32),
                                      jnp.asarray(sc), sent, n_pad)
    tn, ts = tsamp._dedup_with_scores(torch.as_tensor(ids), torch.as_tensor(sc),
                                      sent, n_pad)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
