"""PyTorch port: norm_feat, the activations, SAGEConv, GATConv, the
masked pools, ResPool and DeepGNN (SAGE and GAT; forward, and training
mode with its gradients) against the JAX package's flax modules, under
the same weights (carried over with ``params_from_flax``) and the same
numpy inputs; dropout and dropedge on the port's own generators.  The
last SAGE conv of a center readout, run at the targets' rows alone,
against the same conv at every row.
Tolerance atol 1e-5 / rtol 1e-4 unless stated: the same f32
arithmetic, summed in another order."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.nn import layers as jlayers
from shadow_gnn_tpu.nn import model as jmodel
from shadow_gnn_tpu.nn import respool as jrespool
from shadow_gnn_tpu.ops import segment as jsegment
from shadow_gnn_tpu.sampling.batch import SubgraphBatch as JBatch
from shadow_gnn_tpu.train.pipeline import weighted_loss_fn as j_wloss
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.nn import layers as tlayers
from shadow_gnn_torch.nn import model as tmodel
from shadow_gnn_torch.nn import respool as trespool
from shadow_gnn_torch.ops import segment as tsegment
from shadow_gnn_torch.ops.normalize import adj_norm_rw
from shadow_gnn_torch.ops.packed import packed_spmm
from shadow_gnn_torch.sampling.batch import SubgraphBatch as TBatch
from shadow_gnn_torch.sampling.cache import pack_bits
from shadow_gnn_torch.train.pipeline import weighted_loss_fn as t_wloss

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


def _jax_batch(a, packed=False):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if packed:
        j["adj_bits"] = jnp.asarray(pack_bits(torch.as_tensor(a["adj"])).numpy())
    return JBatch(**j)


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


def _perturb_norms(module, seed):
    """Norm scales and offsets moved off 1 and 0, so that each matters."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("scale", "offset")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("path", ["dense", "packed"])
def test_sage_conv_at_rows_equals_full_conv(path, t):
    """SAGEConv with ``rows`` [B, T] equals the full conv's output at those
    rows: the forward, the input's gradient and every parameter's, in
    training mode at dropout 0.45 and dropedge 0.05 from one generator
    state, on the dense block and on the packed bits (the plain version
    of the packed product and its transposed backward)."""
    a, feat = _batch_arrays(14)
    adj = torch.as_tensor(a["adj"])
    if path == "dense":
        agg = lambda x: torch.bmm(adj_norm_rw(adj, 77, 0.05), x)   # noqa: E731
    else:
        agg = functools.partial(packed_spmm, pack_bits(adj), norm="rw", dropedge=0.05,
                                seed=77)
    rng = np.random.default_rng(15)
    rows = torch.as_tensor(np.stack([rng.permutation(N)[:t] for _ in range(B)]))
    cot = torch.as_tensor(rng.normal(size=(B, t, DIM)).astype(np.float32))
    conv = tlayers.SAGEConv(F, DIM, act="prelu", dropout=0.45)
    tlayers.init_params(conv, torch.Generator().manual_seed(0))
    _perturb_norms(conv, 1)
    conv.train()
    out = []
    for at in (None, rows):
        conv.zero_grad(set_to_none=True)
        tx = torch.tensor(feat, requires_grad=True)
        y = conv(tx, agg, torch.Generator().manual_seed(5), rows=at)
        if at is None:
            y = tlayers.gather_rows(y, rows)
        (y * cot).sum().backward()
        out.append((y.detach(), tx.grad, {k: p.grad for k, p in conv.named_parameters()}))
    (y_full, gx_full, gp_full), (y_rows, gx_rows, gp_rows) = out
    assert y_rows.shape == (B, t, DIM)
    np.testing.assert_allclose(y_rows.numpy(), y_full.numpy(), **TOL)
    np.testing.assert_allclose(gx_rows.numpy(), gx_full.numpy(), **TOL)
    assert set(gp_rows) == set(gp_full)
    for k in gp_full:
        np.testing.assert_allclose(gp_rows[k].numpy(), gp_full[k].numpy(), err_msg=k, **TOL)


def _configs(packed, **extra):
    kw = dict(dim_feat_smooth=F, dim_label_raw=C, dim_label_smooth=0,
              aggr="sage", num_layers=3, dim=DIM, act="relu",
              feature_augment=("hops",), packed_adj=packed, **extra)
    return jmodel.ModelConfig(dim_feat_raw=F, **kw), tmodel.ModelConfig(**kw)


def test_dropout_identity_at_zero():
    x = torch.randn(4, 8, 16)
    assert tlayers.dropout(x, 0.0, None) is x
    gen = torch.Generator().manual_seed(0)
    conv = tlayers.SAGEConv(16, 8, dropout=0.0).train()
    ref = tlayers.SAGEConv(16, 8).eval()
    ref.load_state_dict(conv.state_dict())
    adj = torch.rand(4, 8, 8)
    agg = lambda v: torch.bmm(adj, v)   # noqa: E731
    assert torch.equal(conv(x, agg, gen), ref(x, agg))


@pytest.mark.parametrize("p", [0.1, 0.45])
def test_dropout_kept_fraction_and_scale(p):
    x = torch.full((64, 32, 50), 2.0)                # 102,400 entries
    gen = torch.Generator().manual_seed(3)
    y = tlayers.dropout(x, p, gen)
    kept = y != 0
    sigma = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - (1 - p)) < 4 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / (1 - p)))
    # the mask follows the generator: same state, same mask
    y2 = tlayers.dropout(x, p, torch.Generator().manual_seed(3))
    assert torch.equal(y, y2)
    assert not torch.equal(y, tlayers.dropout(x, p, gen))
    with pytest.raises(ValueError, match="Generator"):
        tlayers.dropout(x, p, None)


@pytest.mark.parametrize("loss", ["softmax", "sigmoid"])
def test_losses_match_jax(loss):
    """loss_fn and weighted_loss_fn (padding rows at weight 0) against
    the JAX package's, softmax (int and one-hot labels) and sigmoid."""
    rng = np.random.default_rng(9)
    logits = (3 * rng.normal(size=(6, C))).astype(np.float32)
    w = np.array([1, 1, 1, 0, 1, 0], np.float32)
    jcfg, tcfg = _configs(False, loss=loss)
    if loss == "sigmoid":
        label_sets = [(rng.random((6, C)) < 0.4).astype(np.float32)]
    else:
        ints = rng.integers(0, C, 6)
        label_sets = [ints, np.eye(C, dtype=np.float32)[ints]]
    from shadow_gnn_tpu.nn.model import loss_fn as j_loss
    for labels in label_sets:
        tl, tlab = torch.as_tensor(logits), torch.as_tensor(labels)
        np.testing.assert_allclose(
            tmodel.loss_fn(tcfg, tl, tlab).item(),
            float(j_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels))),
            rtol=1e-6)
        np.testing.assert_allclose(
            t_wloss(tcfg, tl, tlab, torch.as_tensor(w)).item(),
            float(j_wloss(jcfg, jnp.asarray(logits), jnp.asarray(labels),
                          jnp.asarray(w))), rtol=1e-6)


def _grads_np(model):
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("residue", ["none", "sum"])
@pytest.mark.parametrize("packed", [False, True])
def test_deep_gnn_train_mode_matches_jax(packed, residue):
    """train() mode at dropout 0 / dropedge 0: logits and the gradient of
    weighted_loss_fn for every parameter equal flax apply(train=True)
    (JAX's packed path runs the interpret-mode Pallas kernel and its
    transposed VJP), at rtol 1e-4 / atol 1e-6.  The flagship's center
    readout (residue none, and sum) runs its last conv at the targets'
    rows alone."""
    a, feat = _batch_arrays(11)
    jcfg, tcfg = _configs(packed, residue=residue)
    jm = jmodel.DeepGNN(jcfg)
    args = ([_jax_batch(a, packed)], [jnp.asarray(feat)])
    params = jm.init({"params": jax.random.PRNGKey(1)}, *args,
                     mode_train=True, train=False)
    labels = np.random.default_rng(2).integers(0, C, B)
    w = np.array([1, 1, 0, 1], np.float32)           # a padding row

    def lf(p):
        logits, _ = jm.apply(p, *args, mode_train=True, train=True)
        return j_wloss(jcfg, logits, jnp.asarray(labels), jnp.asarray(w)), logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(lf, has_aux=True)(params)
    tm = tmodel.DeepGNN(tcfg).train()
    tm.load_state_dict(params_from_flax(_np_tree(params)))
    counts = (tmodel.last_conv_rows.target_rows, tmodel.last_conv_rows.full_rows)
    logits, _ = tm(_torch_batch(a, packed), torch.as_tensor(feat),
                   torch.Generator().manual_seed(0), 123)
    assert (tmodel.last_conv_rows.target_rows - counts[0],
            tmodel.last_conv_rows.full_rows - counts[1]) == (1, 0)
    loss = t_wloss(tcfg, logits, torch.as_tensor(labels), torch.as_tensor(w))
    loss.backward()
    tol = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), **tol)
    np.testing.assert_allclose(loss.item(), float(j_loss), **tol)
    want = params_from_flax(_np_tree(j_grads))
    got = _grads_np(tm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("case, at_targets", [
    (dict(), True),
    (dict(residue="sum", act="prelu"), True),
    (dict(residue="max"), True),
    (dict(residue="concat", layer_norm="none"), True),
    (dict(pooling="max"), False),
    (dict(pooling="mean", residue="sum"), False),
    (dict(layer_norm="pairnorm"), False),
    (dict(aggr="gcn"), False),
])
def test_last_conv_at_targets_equals_full_rows(case, at_targets):
    """Which models run their last conv at the targets' rows alone (SAGE
    with center pooling and a row-wise norm; ``last_conv_rows`` counts
    it), and that doing so changes nothing: in training mode at dropout
    0.3 and dropedge 0.1 on the packed path, the loss and every
    gradient equal those of the same model whose readout is taken to
    read every row.  Subgraph 3 is padding (no valid row): the node mask
    gathered at its target zeroes the trimmed conv's row as it does the
    full one's."""
    a, feat = _batch_arrays(16)
    a["node_mask"][3] = False
    cfg = dataclasses.replace(_configs(True, dropout=0.3, dropedge=0.1)[1], **case)
    labels = torch.as_tensor(np.random.default_rng(17).integers(0, C, B))
    m = tmodel.DeepGNN(cfg)
    tlayers.init_params(m, torch.Generator().manual_seed(0))
    _perturb_norms(m, 2)
    m.train()
    out = []
    for trim in (True, False):
        lc = tmodel.last_conv_rows
        counts = (lc.target_rows, lc.full_rows)
        m.zero_grad(set_to_none=True)
        with pytest.MonkeyPatch.context() as mp:
            if not trim:
                mp.setattr(trespool.ResPool, "reads_target_rows",
                           property(lambda self: False))
            logits, _ = m(_torch_batch(a, packed=True), torch.as_tensor(feat),
                          torch.Generator().manual_seed(5), 99)
        loss = t_wloss(cfg, logits, labels, torch.ones(B))
        loss.backward()
        engaged = trim and at_targets
        assert (lc.target_rows - counts[0], lc.full_rows - counts[1]) == (
            (1, 0) if engaged else (0, 1))
        out.append((logits.detach().numpy(), loss.item(), _grads_np(m)))
    (lg_t, l_t, g_t), (lg_f, l_f, g_f) = out
    np.testing.assert_allclose(lg_t, lg_f, **TOL)
    np.testing.assert_allclose(l_t, l_f, rtol=1e-6)
    for k in g_f:
        np.testing.assert_allclose(g_t[k], g_f[k], err_msg=k, **TOL)


def test_packed_and_dense_paths_agree_under_dropedge():
    """One dropedge seed gives the packed and the dense aggregation the
    same mask: equal loss and gradients (dropout on, same generator
    state)."""
    a, feat = _batch_arrays(13)
    _, cfg_dense = _configs(False, dropout=0.3, dropedge=0.4)
    _, cfg_packed = _configs(True, dropout=0.3, dropedge=0.4)
    labels = torch.as_tensor(np.random.default_rng(4).integers(0, C, B))
    w = torch.ones(B)
    out = []
    for cfg, batch in ((cfg_dense, _torch_batch(a)),
                       (cfg_packed, _torch_batch(a, packed=True))):
        m = tmodel.DeepGNN(cfg)
        tlayers.init_params(m, torch.Generator().manual_seed(0))
        m.train()
        logits, _ = m(batch, torch.as_tensor(feat),
                      torch.Generator().manual_seed(5), 2024)
        loss = t_wloss(cfg, logits, labels, w)
        loss.backward()
        out.append((loss.item(), _grads_np(m), logits.detach()))
    (l_d, g_d, lg_d), (l_p, g_p, lg_p) = out
    np.testing.assert_allclose(l_p, l_d, rtol=1e-6)
    for k in g_d:
        np.testing.assert_allclose(g_p[k], g_d[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # and dropedge did act: another seed gives other logits
    m = tmodel.DeepGNN(cfg_packed)
    tlayers.init_params(m, torch.Generator().manual_seed(0))
    m.train()
    with torch.no_grad():
        other, _ = m(_torch_batch(a, packed=True), torch.as_tensor(feat),
                     torch.Generator().manual_seed(5), 2025)
    assert not torch.allclose(other, lg_p)


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
    with pytest.raises(NotImplementedError):
        tmodel.DeepGNN(dataclasses.replace(tcfg, act="softplus"))
    with pytest.raises(ValueError, match="matmul_precision"):
        tmodel.DeepGNN(dataclasses.replace(tcfg, matmul_precision="float16"))
    # training mode with dropout needs its generator
    a, feat = _batch_arrays(1)
    m = tmodel.DeepGNN(dataclasses.replace(tcfg, dropout=0.2)).train()
    with pytest.raises(ValueError, match="Generator"):
        m(_torch_batch(a), torch.as_tensor(feat))


def _perturbed(params, seed=4):
    """Parameters moved off their initial values (norm scales 1, offsets
    0, PReLU slopes 0.25), so that each one matters."""
    return jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(seed), p.shape),
        params)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("name", ["prelu", "prelu+", "elu", "tanh", "leakyrelu",
                                  "relu", "I"])
def test_act_matches_jax(name):
    """Act forward and its gradients (input and PReLU slope)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6, DIM)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    act = jlayers.Act(name, dim_out=DIM)
    params = _perturbed(act.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    def lf(p, x):
        return (act.apply(p, x) * cot).sum()

    want = np.asarray(act.apply(params, jnp.asarray(x)))
    gp, gx = jax.grad(lf, argnums=(0, 1))(params, jnp.asarray(x))
    tact = tlayers.Act(name, DIM)
    if name.startswith("prelu"):
        tact.load_state_dict({"prelu_alpha": torch.as_tensor(
            np.array(params["params"]["prelu_alpha"]))})
    tx = torch.tensor(x, requires_grad=True)
    got = tact(tx)
    (got * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    if name.startswith("prelu"):
        np.testing.assert_allclose(tact.prelu_alpha.grad.numpy(),
                                   np.asarray(gp["params"]["prelu_alpha"]), **TOL)
        assert tact.prelu_alpha.shape == ((DIM,) if name == "prelu+" else (1,))
    else:
        assert not list(tact.parameters())


@pytest.mark.parametrize("act", ["prelu", "prelu+", "relu"])
def test_gat_conv_matches_jax(act):
    """GATConv (the dense branch of the JAX layer) under the same weights:
    the output and the gradient of every parameter and of the input, at
    dropedge-zeroed adjacency with padded tail nodes."""
    heads = 2
    a, feat = _batch_arrays(6)
    adj = a["adj"].copy()
    np.einsum("bii->bi", adj)[:] = a["node_mask"]          # self edges
    adj_norm = adj * (np.random.default_rng(8).random(adj.shape) < 0.7)
    cot = np.random.default_rng(9).normal(size=(B, N, DIM)).astype(np.float32)
    conv = jlayers.GATConv(dim_out=DIM, mulhead=heads, act=act, norm="norm_feat")
    args = (jnp.asarray(feat), jnp.asarray(adj_norm), jnp.asarray(adj),
            jnp.asarray(a["node_mask"]))
    params = _perturbed(conv.init(jax.random.PRNGKey(3), *args, train=False))

    def lf(p, x):
        return (conv.apply(p, x, *args[1:], train=False) * cot).sum()

    want = np.asarray(conv.apply(params, *args, train=False))
    gp, gx = jax.grad(lf, argnums=(0, 1))(params, args[0])
    sd = params_from_flax({"conv_0_0": _np_tree(params)["params"]})
    tconv = tlayers.GATConv(F, DIM, heads, act=act)
    tconv.load_state_dict(_strip(sd, "convs.0."))
    tx = torch.tensor(feat, requires_grad=True)
    got = tconv(tx, (torch.as_tensor(adj_norm), torch.as_tensor(adj)))
    (got * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    want_g = _strip(params_from_flax({"conv_0_0": _np_tree(gp)["params"]}), "convs.0.")
    for k, p in tconv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("pool", ["sum", "mean", "max"])
def test_masked_pools_match_jax(pool):
    """Forward and input gradient; block 3 has no valid row (pools to 0),
    and the max pool ties on two rows of block 0 (amax splits its
    gradient as JAX's max does)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 7, 5)).astype(np.float32)
    x[0, 2] = x[0, 4]
    mask = rng.random((4, 7)) < 0.6
    mask[0, [2, 4]] = True
    mask[3] = False
    cot = rng.normal(size=(4, 5)).astype(np.float32)
    jfn = getattr(jsegment, f"masked_{pool}_pool")
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(mask)))
    gx = jax.grad(lambda v: (jfn(v, jnp.asarray(mask)) * cot).sum())(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = getattr(tsegment, f"masked_{pool}_pool")(tx, torch.as_tensor(mask))
    (got * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    assert not got[3].detach().any()


@pytest.mark.parametrize("residue", ["none", "sum", "max", "concat"])
@pytest.mark.parametrize("pool", ["center", "mean", "max", "sum"])
def test_respool_matches_jax(residue, pool):
    """ResPool over every residue x pooling: output and the gradients of
    its parameters and inputs (prelu activation)."""
    a, _ = _batch_arrays(12)
    rng = np.random.default_rng(13)
    layers = [rng.normal(size=(B, N, DIM)).astype(np.float32) for _ in range(3)]
    rp = jrespool.ResPool(dim_hid=DIM, num_layers=3, type_res=residue,
                          type_pool=pool, dropout=0.0, act="prelu")
    targets, mask = jnp.asarray(a["targets"]), jnp.asarray(a["node_mask"])
    jl = [jnp.asarray(x) for x in layers]
    params = rp.init(jax.random.PRNGKey(2), jl, targets, mask, train=False)
    params = _perturbed(params) if params else params
    want = np.asarray(rp.apply(params, jl, targets, mask, train=False))
    cot = rng.normal(size=want.shape).astype(np.float32)
    gp, gl = jax.grad(lambda p, f: (rp.apply(p, f, targets, mask, train=False)
                                    * cot).sum(), argnums=(0, 1))(params, jl)
    trp = trespool.ResPool(DIM, 3, residue, pool, 0.0, "prelu")
    sd = params_from_flax({"res_pool_0": _np_tree(params).get("params", {})})
    trp.load_state_dict(_strip(sd, "res_pool."))
    tl = [torch.tensor(x, requires_grad=True) for x in layers]
    got = trp(tl, torch.as_tensor(a["targets"]).long(), torch.as_tensor(a["node_mask"]))
    (got * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    for k in range(3):
        # with no residue only the last layer is read
        g = tl[k].grad if tl[k].grad is not None else torch.zeros(B, N, DIM)
        np.testing.assert_allclose(g.numpy(), np.asarray(gl[k]),
                                   err_msg=f"layer {k}", **TOL)
    want_g = _strip(params_from_flax({"res_pool_0": _np_tree(gp).get("params", {})}),
                    "res_pool.")
    assert set(want_g) == {k for k, _ in trp.named_parameters()}
    for k, p in trp.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, **TOL)


D_LAB = 6


def _gat_configs(fused):
    kw = dict(dim_feat_smooth=F, dim_label_raw=C, dim_label_smooth=D_LAB,
              aggr="gat", num_layers=2, dim=DIM, heads=2, act="prelu",
              residue="max", pooling="max", feature_augment=("hops",))
    return (jmodel.ModelConfig(dim_feat_raw=F, fused_gat=fused, **kw),
            tmodel.ModelConfig(**kw))


@pytest.mark.parametrize("fused", [False, True])
def test_gat_model_matches_jax(fused):
    """A whole GAT-2 model (2 heads, prelu, max residue and max pooling,
    label-input columns, hop augment) under params_from_flax, against
    flax apply with the dense score chain (fused_gat=False) and with the
    Pallas kernel in interpret mode (fused_gat=True, the head-major
    chain): serving logits and embeddings (mode_train False), and in
    training mode at dropout / dropedge 0 (mode_train True) the loss and
    every gradient."""
    a, feat = _batch_arrays(5)
    adj = a["adj"].copy()
    np.einsum("bii->bi", adj)[:] = a["node_mask"]          # GAT's self edges
    a["adj"] = adj
    lab = np.random.default_rng(6).random((B, N, D_LAB)).astype(np.float32)
    feat = np.concatenate([feat, lab], -1)
    jcfg, tcfg = _gat_configs(fused)
    jm = jmodel.DeepGNN(jcfg)
    args = ([_jax_batch(a)], [jnp.asarray(feat)])
    params = _perturbed(jm.init({"params": jax.random.PRNGKey(0)}, *args,
                                mode_train=True, train=False))
    tm = tmodel.DeepGNN(tcfg)
    tm.load_state_dict(params_from_flax(_np_tree(params)))
    want_logits, want_emb = jm.apply(params, *args, mode_train=False, train=False)
    with torch.no_grad():
        logits, emb = tm.eval()(_torch_batch(a), torch.as_tensor(feat))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(emb[0].numpy(), np.asarray(want_emb[0]), **TOL)

    labels = np.random.default_rng(2).integers(0, C, B)
    w = np.array([1, 1, 0, 1], np.float32)

    def lf(p):
        lg, _ = jm.apply(p, *args, mode_train=True, train=True)
        return j_wloss(jcfg, lg, jnp.asarray(labels), jnp.asarray(w))

    j_loss, j_grads = jax.value_and_grad(lf)(params)
    logits, _ = tm.train()(_torch_batch(a), torch.as_tensor(feat),
                           torch.Generator().manual_seed(0), 0, True)
    loss = t_wloss(tcfg, logits, torch.as_tensor(labels), torch.as_tensor(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = params_from_flax(_np_tree(j_grads))
    got = _grads_np(tm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-6)
