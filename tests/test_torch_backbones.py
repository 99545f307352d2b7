"""PyTorch port, the rest of the model matrix at the layer level: pairnorm,
GCNConv, GINConv, GATScatterConv, the MLP conv of mlp/sgc/sign and GAT
with pairnorm against the JAX package's flax layers (their dense
branches), under the same weights (``params_from_flax`` with the
backbone's ``aggr`` and ``layer_norm``) and the same numpy inputs: the
forward, and the gradients of every parameter and of the input
(``jax.grad`` against autograd) at dropout 0; the ``pprs`` one-hot;
and ``params_from_flax`` over a whole DeepGNN of every backbone and
norm.  Tolerance atol 1e-5 / rtol 1e-4: the same f32 arithmetic,
summed in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.nn import layers as jlayers
from shadow_gnn_tpu.nn import model as jmodel
from shadow_gnn_tpu.sampling import batch as jbatch
from shadow_gnn_tpu.sampling.batch import SubgraphBatch as JBatch
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.nn import layers as tlayers
from shadow_gnn_torch.nn import model as tmodel
from shadow_gnn_torch.ops.normalize import adj_norm_sym
from shadow_gnn_torch.sampling import batch as tbatch

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
B, N, F, DIM, HEADS = 4, 20, 12, 16, 2


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _perturbed(params, seed=4):
    """Parameters moved off their initial values (norm scales 1, offsets
    0, GIN's eps 0, GATScatter's biases 0), so that each one matters."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        tree, [p + 0.1 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])


def _blocks(seed=0):
    """(features [B, N, F], node mask, 0/1 symmetric blocks with self
    edges on the valid rows): subgraphs of 20, 13, 1 and 7 nodes, a row
    of the last one isolated but for its self edge."""
    rng = np.random.default_rng(seed)
    sizes = (N, 13, 1, 7)
    mask = np.zeros((B, N), bool)
    adj = np.zeros((B, N, N), np.float32)
    for b, s in enumerate(sizes):
        mask[b, :s] = True
        a = (rng.random((s, s)) < 0.3).astype(np.float32)
        adj[b, :s, :s] = np.maximum(a, a.T)
    adj[3, 2, :], adj[3, :, 2] = 0.0, 0.0
    np.einsum("bii->bi", adj)[:] = mask
    feat = rng.normal(size=(B, N, F)).astype(np.float32) * mask[..., None]
    return feat, mask, adj


def test_pairnorm_matches_jax():
    """Masked rows, a subgraph of two equal rows (all null after
    centring: passed through), a one-node subgraph; forward and the
    gradient of a weighted sum."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32) * 2 + 1
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0]],
                    bool)
    x[1, 1] = x[1, 0]
    x[~mask] = 0.0
    g = rng.normal(size=x.shape).astype(np.float32)

    def jf(x):
        return (jlayers.pairnorm(x, jnp.asarray(mask)) * g).sum()

    want = np.asarray(jlayers.pairnorm(jnp.asarray(x), jnp.asarray(mask)))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_()
    got = tlayers.pairnorm(xt, torch.as_tensor(mask))
    (got * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, **TOL)
    # the null rows pass through, scaled to unit norm; padding rows are
    # zero
    for b, i in ((1, 0), (1, 1), (2, 0)):
        np.testing.assert_allclose(want[b, i], x[b, i] / np.linalg.norm(x[b, i]),
                                   rtol=1e-5)
    assert not want[~mask].any()


JCONV = {"gcn": jlayers.GCNConv, "gin": jlayers.GINConv,
         "gatscat": jlayers.GATScatterConv, "mlp": jlayers.MLPLayer,
         "gat": jlayers.GATConv, "sage": jlayers.SAGEConv}


def _conv_inputs(aggr, adj):
    """(JAX's (adj_norm, adj_struct), the port's aggregation argument)."""
    if aggr == "mlp":
        return (None, None), None
    if aggr in ("gat", "gatscat"):
        return (jnp.asarray(adj), jnp.asarray(adj)), (torch.as_tensor(adj),) * 2
    blk = adj_norm_sym(torch.as_tensor(adj)) if aggr == "gcn" else torch.as_tensor(adj)
    if aggr == "sage":
        blk = blk / torch.clamp(blk.sum(-1, keepdim=True), min=1.0)
    return (jnp.asarray(blk.numpy()), jnp.asarray(adj)), lambda x: torch.bmm(blk, x)


@pytest.mark.parametrize("aggr,norm,act", [
    ("gcn", "norm_feat", "relu"), ("gcn", "pairnorm", "prelu+"),
    ("gin", "norm_feat", "relu"), ("gin", "pairnorm", "elu"),
    ("gatscat", "norm_feat", "relu"), ("gatscat", "pairnorm", "prelu"),
    ("mlp", "norm_feat", "relu"), ("mlp", "pairnorm", "tanh"),
    ("gat", "pairnorm", "relu"), ("sage", "pairnorm", "relu")])
def test_conv_matches_jax(aggr, norm, act):
    """One conv of each new kind and norm (and GAT and SAGE under
    pairnorm) against its flax layer: the output and the gradients of a
    weighted sum of it with respect to every parameter and the input."""
    feat, mask, adj = _blocks(1)
    (j_an, j_as), t_agg = _conv_inputs(aggr, adj)
    jconv = JCONV[aggr](dim_out=DIM, act=act, norm=norm, mulhead=HEADS)
    args = (jnp.asarray(feat), j_an, j_as, jnp.asarray(mask))
    params = _perturbed(jconv.init(jax.random.PRNGKey(2), *args, train=False))
    g_out = np.random.default_rng(5).normal(size=(B, N, DIM)).astype(np.float32)

    def jf(p, x):
        return (jconv.apply(p, x, *args[1:], train=True) * g_out).sum()

    want = np.asarray(jconv.apply(params, *args, train=False))
    want_gp, want_gx = jax.grad(jf, argnums=(0, 1))(params, args[0])
    kw = dict(heads=HEADS) if aggr in tlayers.ATTENTION else {}
    tconv = tlayers.NAME2LAYER[aggr](F, DIM, act=act, norm=norm, **kw)
    sd = params_from_flax({"conv_0_0": _np_tree(params)["params"]}, aggr=aggr,
                          layer_norm=norm)
    tconv.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    x = torch.as_tensor(feat).requires_grad_()
    got = tconv.train()(x, t_agg, torch.Generator().manual_seed(0),
                        node_mask=torch.as_tensor(mask))
    (got * torch.as_tensor(g_out)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_gx), **TOL)
    want_g = params_from_flax({"conv_0_0": _np_tree(want_gp)["params"]}, aggr=aggr,
                              layer_norm=norm)
    got_g = {k: p.grad.numpy() for k, p in tconv.named_parameters()}
    assert set(got_g) == {k[len("convs.0."):] for k in want_g}
    for k, v in want_g.items():
        np.testing.assert_allclose(got_g[k[len("convs.0."):]], v.numpy(),
                                   err_msg=k, **TOL)
    if norm == "pairnorm":
        assert not hasattr(tconv, "scale")


def test_gatscat_init_distribution():
    """init_params draws GATScatter's w_src, w_dst and attention from the
    xavier-normal of JAX's layer (gain sqrt(2) for relu, 1 otherwise;
    fan_in shape[0], fan_out shape[-1]) and zeroes the biases."""
    for act, gain in (("relu", 2 ** 0.5), ("elu", 1.0)):
        conv = tlayers.GATScatterConv(400, 256, 4, act=act)
        with torch.no_grad():
            conv.b_src.fill_(1.0)
        tlayers.init_params(conv, torch.Generator().manual_seed(0))
        for w in (conv.w_src, conv.w_dst, conv.attention):
            want = gain * (2.0 / (w.shape[0] + w.shape[-1])) ** 0.5
            # four standard errors of a sample std
            tol = 4.0 / (2.0 * w.numel()) ** 0.5
            assert abs(float(w.detach().std()) / want - 1) < tol, (act, w.shape)
            assert abs(float(w.detach().mean())) < 4.0 * want / w.numel() ** 0.5
        assert not conv.b_src.any() and not conv.b_dst.any()


@pytest.mark.parametrize("dim", [1, 3])
def test_ppr2onehot_matches_jax(dim):
    ppr = np.array([[0.0, 1e-6, 0.01, 0.0625, 0.1, 0.25, 0.3, 0.99, 1.0, 1.5,
                     -0.1]], np.float32)
    want = np.asarray(jbatch.ppr2onehot(jnp.asarray(ppr), dim))
    got = tbatch.ppr2onehot(torch.as_tensor(ppr), dim).numpy()
    np.testing.assert_array_equal(got, want)
    assert tbatch.AUG2DIM["pprs"] == jbatch.AUG2DIM["pprs"] == 1


AGGRS = ["sage", "gcn", "gin", "gat", "gatscat", "mlp", "sgc", "sign"]


@pytest.mark.parametrize("norm", ["norm_feat", "pairnorm"])
@pytest.mark.parametrize("aggr", AGGRS)
def test_params_from_flax_every_backbone(aggr, norm):
    """A whole DeepGNN of each backbone and norm: every JAX leaf lands in
    the port's state_dict (bar a pairnorm conv's unread scale/offset),
    with its shape, and no port parameter is left unset."""
    feat, mask, adj = _blocks(2)
    kw = dict(dim_feat_smooth=F, dim_label_raw=3, dim_label_smooth=0, aggr=aggr,
              num_layers=2, dim=DIM, heads=HEADS, act="prelu", layer_norm=norm,
              feature_augment=("hops", "pprs"))
    jcfg = jmodel.ModelConfig(dim_feat_raw=F, **kw)
    jb = JBatch(nodes=jnp.zeros((B, N), jnp.int32), node_mask=jnp.asarray(mask),
                adj=jnp.asarray(adj), targets=jnp.zeros((B, 1), jnp.int32),
                size=jnp.asarray(mask.sum(1).astype(np.int32)),
                hop=jnp.zeros((B, N), jnp.int32), ppr=jnp.zeros((B, N)),
                drnl=jnp.zeros((B, N), jnp.int32))
    params = _np_tree(jmodel.DeepGNN(jcfg).init(
        jax.random.PRNGKey(0), [jb], [jnp.asarray(feat)], mode_train=False,
        train=False))
    sd = params_from_flax(params, aggr=aggr, layer_norm=norm)
    tm = tmodel.DeepGNN(tmodel.ModelConfig(**kw))
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    dropped = [p for p, _ in leaves if norm == "pairnorm"
               and str(p[1]).find("conv_") >= 0
               and str(p[-1].key) in ("scale", "offset")]
    assert sum(v.numel() for v in sd.values()) == sum(
        np.size(v) for p, v in leaves if p not in dropped)
    assert len(dropped) == (4 if norm == "pairnorm" else 0)
    tm.load_state_dict(sd)
