"""PyTorch port, the link task's model against the JAX package's flax
modules under the same weights (``params_from_flax(...,
prediction_task="link")``) and the same numpy inputs: sort pooling
(forward and gradient, with ties and with fewer valid rows than k),
ResPool's link readout (src * dst of the two targets' rows) for center,
mean and sort pooling with and without the concat residue, and a whole
link SAGE-2 model (DRNL one-hots concatenated to the features, concat
residue, sort-8 pooling, a classifier without norm): logits, embeddings,
the sigmoid loss and every gradient at dropout and dropedge 0.
Tolerance atol 1e-5 / rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.nn import model as jmodel
from shadow_gnn_tpu.nn import respool as jrespool
from shadow_gnn_tpu.ops import segment as jsegment
from shadow_gnn_tpu.sampling.batch import SubgraphBatch as JBatch
from shadow_gnn_tpu.train.pipeline import weighted_loss_fn as j_wloss
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.nn import model as tmodel
from shadow_gnn_torch.nn import respool as trespool
from shadow_gnn_torch.ops import segment as tsegment
from shadow_gnn_torch.sampling.batch import SubgraphBatch as TBatch
from shadow_gnn_torch.train.pipeline import weighted_loss_fn as t_wloss

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
B, N, F, DIM = 4, 24, 12, 16


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _perturbed(params, seed=4):
    return jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(seed), p.shape),
        params)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("k", [3, 5, 7])
def test_masked_sort_pool_matches_jax(k):
    """Rows tie on the last channel (block 0; the stable sort keeps the
    lower index first, as jnp.argsort), block 1 has fewer valid rows than
    k (zero rows follow), block 3 none at all."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 7, 5)).astype(np.float32)
    x[0, 2, -1] = x[0, 5, -1] = x[0, 1, -1]
    mask = rng.random((4, 7)) < 0.7
    mask[0] = True
    mask[1] = [True, False, True, False, False, False, False]
    mask[3] = False
    cot = rng.normal(size=(4, k * 5)).astype(np.float32)
    want = np.asarray(jsegment.masked_sort_pool(jnp.asarray(x), jnp.asarray(mask), k))
    gx = jax.grad(lambda v: (jsegment.masked_sort_pool(v, jnp.asarray(mask), k)
                             * cot).sum())(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = tsegment.masked_sort_pool(tx, torch.as_tensor(mask), k)
    (got * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    assert not got[3].detach().any() and not got[1, 2 * 5:].detach().any()


def _link_batch(seed=0):
    """A padded batch of two-target subgraphs: symmetric blocks without
    the target-target entry, DRNL labels including 255 and out-of-range
    values."""
    rng = np.random.default_rng(seed)
    sizes = np.array([N, 17, 9, 20])
    nodes = np.full((B, N), 1000, np.int32)
    mask = np.zeros((B, N), bool)
    adj = np.zeros((B, N, N), np.float32)
    targets = np.zeros((B, 2), np.int32)
    for b, s in enumerate(sizes):
        nodes[b, :s] = np.sort(rng.choice(1000, s, replace=False))
        mask[b, :s] = True
        a = (rng.random((s, s)) < 0.25).astype(np.float32)
        adj[b, :s, :s] = np.maximum(a, a.T)
        targets[b] = rng.choice(s, 2, replace=False)
        adj[b, targets[b, 0], targets[b, 1]] = adj[b, targets[b, 1], targets[b, 0]] = 0
    drnl = np.where(mask, rng.choice([1, 2, 3, 5, 8, 13, 30, 255], (B, N)), 0)
    feat = rng.normal(size=(B, N, F)).astype(np.float32)
    return dict(nodes=nodes, node_mask=mask, adj=adj, targets=targets,
                size=sizes.astype(np.int32), hop=np.full((B, N), -1, np.int32),
                ppr=np.zeros((B, N), np.float32),
                drnl=drnl.astype(np.int32)), feat


@pytest.mark.parametrize("residue", ["none", "concat"])
@pytest.mark.parametrize("pool", ["center", "mean", "sort-5"])
def test_link_respool_matches_jax(residue, pool):
    """The link readout: output and the gradients of its parameters
    (PReLU's one slope serves nn_pool and the trailing linear) and of
    its inputs."""
    a, _ = _link_batch(12)
    rng = np.random.default_rng(13)
    layers = [rng.normal(size=(B, N, DIM)).astype(np.float32) for _ in range(3)]
    tp, k = (pool.split("-") + ["0"])[:2]
    rp = jrespool.ResPool(dim_hid=DIM, num_layers=3, type_res=residue, type_pool=tp,
                          dropout=0.0, act="prelu", sort_k=int(k),
                          prediction_task="link")
    targets, mask = jnp.asarray(a["targets"]), jnp.asarray(a["node_mask"])
    jl = [jnp.asarray(x) for x in layers]
    params = _perturbed(rp.init(jax.random.PRNGKey(2), jl, targets, mask, train=False))
    want = np.asarray(rp.apply(params, jl, targets, mask, train=False))
    assert want.shape == (B, DIM)
    cot = rng.normal(size=want.shape).astype(np.float32)
    gp, gl = jax.grad(lambda p, f: (rp.apply(p, f, targets, mask, train=False)
                                    * cot).sum(), argnums=(0, 1))(params, jl)
    trp = trespool.ResPool(DIM, 3, residue, tp, 0.0, "prelu", "link",
                           sort_k=int(k))
    sd = params_from_flax({"res_pool_0": _np_tree(params)["params"]},
                          prediction_task="link")
    trp.load_state_dict(_strip(sd, "res_pool."))
    tl = [torch.tensor(x, requires_grad=True) for x in layers]
    got = trp(tl, torch.as_tensor(a["targets"]).long(), torch.as_tensor(a["node_mask"]))
    (got * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    for i in range(3):
        g = tl[i].grad if tl[i].grad is not None else torch.zeros(B, N, DIM)
        np.testing.assert_allclose(g.numpy(), np.asarray(gl[i]), err_msg=f"layer {i}",
                                   **TOL)
    want_g = _strip(params_from_flax({"res_pool_0": _np_tree(gp)["params"]},
                                     prediction_task="link"), "res_pool.")
    assert set(want_g) == {n for n, _ in trp.named_parameters()}
    assert ("nn_pool.weight" in want_g) == (tp == "sort")
    for n, p in trp.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(), err_msg=n, **TOL)


def _configs(packed, **extra):
    kw = dict(dim_feat_smooth=F, dim_label_raw=1, dim_label_smooth=0,
              aggr="sage", num_layers=2, dim=DIM, act="elu", loss="sigmoid",
              feature_augment=("drnls",), feature_augment_ops="concat",
              residue="concat", pooling="sort-8", prediction_task="link",
              packed_adj=packed, **extra)
    return jmodel.ModelConfig(dim_feat_raw=F, **kw), tmodel.ModelConfig(**kw)


@pytest.mark.parametrize("packed", [False, True])
def test_link_model_matches_jax(packed):
    """The link SAGE-2 model (packed_adj on a batch without packed bits
    takes the dense block, as every link batch does): serving logits and
    embeddings, then in training mode at p = 0 the weighted sigmoid loss
    and every gradient.  The first conv reads F + DIM columns."""
    a, feat = _link_batch(5)
    jcfg, tcfg = _configs(packed)
    jm = jmodel.DeepGNN(jcfg)
    args = ([JBatch(**{k: jnp.asarray(v) for k, v in a.items()})], [jnp.asarray(feat)])
    params = _perturbed(jm.init({"params": jax.random.PRNGKey(0)}, *args,
                                mode_train=True, train=False))
    tm = tmodel.DeepGNN(tcfg)
    tm.load_state_dict(params_from_flax(_np_tree(params), prediction_task="link"))
    assert tm.convs[0].lin_self.weight.shape == (DIM, F + DIM)
    assert tm.res_pool.nn_pool.weight.shape == (2 * DIM, 8 * 2 * DIM)
    assert not hasattr(tm.classifier[0], "scale")
    tb = {k: torch.as_tensor(v) for k, v in a.items()}
    for k in ("nodes", "targets", "hop", "drnl", "size"):
        tb[k] = tb[k].long()
    tb = TBatch(**tb)
    want_logits, want_emb = jm.apply(params, *args, mode_train=False, train=False)
    with torch.no_grad():
        logits, emb = tm.eval()(tb, torch.as_tensor(feat))
    assert logits.shape == (B, 1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(emb[0].numpy(), np.asarray(want_emb[0]), **TOL)

    labels = np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)
    w = np.array([1, 1, 0, 1], np.float32)

    def lf(p):
        lg, _ = jm.apply(p, *args, mode_train=True, train=True)
        return j_wloss(jcfg, lg, jnp.asarray(labels), jnp.asarray(w))

    j_loss, j_grads = jax.value_and_grad(lf)(params)
    logits, _ = tm.train()(tb, torch.as_tensor(feat), torch.Generator().manual_seed(0),
                           0, True)
    loss = t_wloss(tcfg, logits, torch.as_tensor(labels), torch.as_tensor(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = params_from_flax(_np_tree(j_grads), prediction_task="link")
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, rtol=1e-4,
                                   atol=1e-6)
