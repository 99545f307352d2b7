"""PyTorch port: norm_feat, SAGEConv and the DeepGNN forward against the
JAX package's flax modules, under the same weights (carried over with
``params_from_flax``) and the same numpy inputs.  Tolerance atol 1e-5 /
rtol 1e-4: the same f32 arithmetic, summed in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.nn import layers as jlayers
from shadow_gnn_tpu.nn import model as jmodel
from shadow_gnn_tpu.sampling.batch import SubgraphBatch as JBatch
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.nn import layers as tlayers
from shadow_gnn_torch.nn import model as tmodel
from shadow_gnn_torch.ops.normalize import adj_norm_rw
from shadow_gnn_torch.sampling.batch import SubgraphBatch as TBatch
from shadow_gnn_torch.sampling.cache import pack_bits

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
B, N, F, DIM, C = 4, 24, 16, 32, 5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _batch_arrays(seed=0):
    """A random padded batch: sorted ids (padding = num_nodes), symmetric
    0/1 blocks over valid rows, hops including out-of-range values."""
    rng = np.random.default_rng(seed)
    num_nodes = 1000
    sizes = np.array([N, 17, 9, 20])
    nodes = np.full((B, N), num_nodes, np.int32)
    mask = np.zeros((B, N), bool)
    adj = np.zeros((B, N, N), np.float32)
    for b, s in enumerate(sizes):
        nodes[b, :s] = np.sort(rng.choice(num_nodes, s, replace=False))
        mask[b, :s] = True
        a = (rng.random((s, s)) < 0.25).astype(np.float32)
        adj[b, :s, :s] = np.maximum(a, a.T)
    targets = np.array([[rng.integers(s)] for s in sizes], np.int32)
    hop = np.where(mask, rng.integers(-1, 8, (B, N)), -1).astype(np.int32)
    feat = rng.normal(size=(B, N, F)).astype(np.float32)
    return dict(nodes=nodes, node_mask=mask, adj=adj, targets=targets,
                size=sizes.astype(np.int32), hop=hop,
                ppr=np.zeros((B, N), np.float32),
                drnl=np.zeros((B, N), np.int32)), feat


def _jax_batch(a):
    return JBatch(**{k: jnp.asarray(v) for k, v in a.items()})


def _torch_batch(a, packed=False):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    for k in ("nodes", "targets", "hop", "drnl", "size"):
        t[k] = t[k].long()
    if packed:
        t["adj_bits"], t["adj"] = pack_bits(t["adj"]), None
    return TBatch(**t)


def test_norm_feat_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, DIM)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(DIM,)).astype(np.float32)
    offset = rng.normal(size=(DIM,)).astype(np.float32)
    want = np.asarray(jlayers.norm_feat(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(offset)))
    got = tlayers.norm_feat(torch.as_tensor(x), torch.as_tensor(scale),
                            torch.as_tensor(offset)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("act", ["relu", "I"])
def test_sage_conv_matches_jax(act):
    a, feat = _batch_arrays(2)
    adj_n = np.asarray(adj_norm_rw(torch.as_tensor(a["adj"])))
    conv = jlayers.SAGEConv(dim_out=DIM, act=act, norm="norm_feat")
    args = (jnp.asarray(feat), jnp.asarray(adj_n), None,
            jnp.asarray(a["node_mask"]))
    params = conv.init(jax.random.PRNGKey(3), *args, train=False)
    # non-trivial norm parameters
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(4), p.shape),
        params)
    want = np.asarray(conv.apply(params, *args, train=False))
    sd = params_from_flax({"conv_0_0": _np_tree(params)["params"]})
    tconv = tlayers.SAGEConv(F, DIM, act=act)
    tconv.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    adj_t = torch.as_tensor(adj_n)
    with torch.no_grad():
        got = tconv(torch.as_tensor(feat), lambda x: torch.bmm(adj_t, x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _configs(packed):
    kw = dict(dim_feat_smooth=F, dim_label_raw=C, dim_label_smooth=0,
              aggr="sage", num_layers=3, dim=DIM, act="relu",
              feature_augment=("hops",), packed_adj=packed)
    return jmodel.ModelConfig(dim_feat_raw=F, **kw), tmodel.ModelConfig(**kw)


def test_deep_gnn_forward_matches_jax():
    a, feat = _batch_arrays(5)
    jcfg, tcfg = _configs(False)
    jm = jmodel.DeepGNN(jcfg)
    args = ([_jax_batch(a)], [jnp.asarray(feat)])
    params = jm.init({"params": jax.random.PRNGKey(0)}, *args,
                     mode_train=False, train=False)
    want_logits, want_emb = jm.apply(params, *args, mode_train=False, train=False)
    tm = tmodel.DeepGNN(tcfg).eval()
    tm.load_state_dict(params_from_flax(_np_tree(params)))
    with torch.no_grad():
        logits, emb = tm(_torch_batch(a), torch.as_tensor(feat))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(emb[0].numpy(), np.asarray(want_emb[0]), **TOL)
    np.testing.assert_allclose(
        tmodel.predict_fn(tcfg, logits).numpy(),
        np.asarray(jmodel.predict_fn(jcfg, want_logits)), **TOL)


def test_packed_path_equals_dense_path():
    a, feat = _batch_arrays(7)
    _, cfg_dense = _configs(False)
    _, cfg_packed = _configs(True)
    dense = tmodel.DeepGNN(cfg_dense).eval()
    tlayers.init_params(dense, torch.Generator().manual_seed(0))
    packed = tmodel.DeepGNN(cfg_packed).eval()
    packed.load_state_dict(dense.state_dict())
    calls = tmodel.packed_spmm.calls
    with torch.no_grad():
        want, _ = dense(_torch_batch(a), torch.as_tensor(feat))
        got, _ = packed(_torch_batch(a, packed=True), torch.as_tensor(feat))
    assert tmodel.packed_spmm.calls == calls + cfg_packed.num_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_unported_branches_raise():
    _, tcfg = _configs(False)
    import dataclasses
    for bad in (dict(aggr="gat"), dict(num_ensemble=2), dict(pooling="mean"),
                dict(dim_label_smooth=3), dict(layer_norm="pairnorm"),
                dict(act="elu")):
        with pytest.raises(NotImplementedError):
            tmodel.DeepGNN(dataclasses.replace(tcfg, **bad))
    # training (dropout, dropedge, the backward) comes with the next slice
    a, feat = _batch_arrays(1)
    with pytest.raises(NotImplementedError, match="training"):
        tmodel.DeepGNN(tcfg).train()(_torch_batch(a), torch.as_tensor(feat))
