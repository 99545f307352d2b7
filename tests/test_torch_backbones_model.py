"""PyTorch port, the rest of the model matrix at the model level: DeepGNN
of the gcn, gin, gatscat, mlp, sgc and sign backbones (and every
backbone under ``layer_norm: pairnorm``) against the JAX package's flax
DeepGNN (its dense branch, ``fused_gat=False``; GCN and GIN with
``packed_adj`` on packed batches take JAX's packed path, the Pallas
kernel in interpret mode, in its ``sym`` and ``gin`` norms, and the
port's plain ``packed_spmm``), under the same weights
(``params_from_flax(..., aggr=, layer_norm=)``): serving logits and
embeddings, and in training mode at dropout 0 the loss and every
gradient.  f32 at atol 1e-5 / rtol 1e-4 (gradients atol 1e-6); under
``matmul_precision="bfloat16"`` at 2e-2 of the largest value, on the
smooth elu (JAX on the CPU keeps its XLA products f32, the port rounds
every product: tests/test_torch_bf16_model.py; GIN also against JAX
with every product rounded to bf16, at 2e-2).  Also padding
invariance for all eight backbones, as tests/test_layers.py holds it for
JAX, and a ``hops-pprs`` concat model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.nn import model as jmodel
from shadow_gnn_tpu.sampling.batch import SubgraphBatch as JBatch
from shadow_gnn_tpu.train.pipeline import weighted_loss_fn as j_wloss
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.nn import layers as tlayers
from shadow_gnn_torch.nn import model as tmodel
from shadow_gnn_torch.sampling.batch import SubgraphBatch as TBatch
from shadow_gnn_torch.sampling.cache import pack_bits
from shadow_gnn_torch.train.pipeline import weighted_loss_fn as t_wloss

torch.set_num_threads(2)
B, N, F, DIM, C = 4, 24, 12, 16, 5
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 2e-2
LABELS = np.random.default_rng(2).integers(0, C, B)
W = np.array([1, 1, 0, 1], np.float32)          # a padding row
NEW = ["gcn", "gin", "gatscat", "mlp", "sgc", "sign"]
# a readout per backbone, so that the grid is covered
READOUT = {"gcn": ("concat", "center"), "gin": ("max", "max"),
           "gatscat": ("sum", "mean"), "mlp": ("none", "center"),
           "sgc": ("max", "sum"), "sign": ("concat", "mean"),
           "sage": ("none", "center"), "gat": ("max", "max")}


def _batch_arrays(seed=5):
    """A random padded batch: sorted ids, symmetric 0/1 blocks with self
    edges over the valid rows, hops with out-of-range values, PPR scores
    in [0, 1.2)."""
    rng = np.random.default_rng(seed)
    sizes = np.array([N, 17, 1, 20])
    nodes = np.full((B, N), 1000, np.int32)
    mask = np.zeros((B, N), bool)
    adj = np.zeros((B, N, N), np.float32)
    for b, s in enumerate(sizes):
        nodes[b, :s] = np.sort(rng.choice(1000, s, replace=False))
        mask[b, :s] = True
        a = (rng.random((s, s)) < 0.25).astype(np.float32)
        adj[b, :s, :s] = np.maximum(a, a.T)
    np.einsum("bii->bi", adj)[:] = mask
    targets = np.array([[rng.integers(s)] for s in sizes], np.int32)
    hop = np.where(mask, rng.integers(-1, 8, (B, N)), -1).astype(np.int32)
    ppr = np.where(mask, rng.random((B, N)) * 1.2, 0).astype(np.float32)
    feat = (rng.normal(size=(B, N, F)) * mask[..., None]).astype(np.float32)
    return dict(nodes=nodes, node_mask=mask, adj=adj, targets=targets,
                size=sizes.astype(np.int32), hop=hop, ppr=ppr,
                drnl=np.zeros((B, N), np.int32)), feat


def _case(aggr, act="prelu", packed=False, precision="float32", **extra):
    """(jax cfg, torch cfg, jax args, torch batch, feat)."""
    a, feat = _batch_arrays()
    residue, pooling = READOUT[aggr]
    kw = dict(dim_feat_smooth=F, dim_label_raw=C, dim_label_smooth=0, aggr=aggr,
              num_layers=2, dim=DIM, heads=2, act=act, residue=residue,
              pooling=pooling, feature_augment=("hops",), packed_adj=packed)
    kw.update(extra)
    jcfg = jmodel.ModelConfig(dim_feat_raw=F, fused_gat=False, **kw)
    tcfg = tmodel.ModelConfig(matmul_precision=precision, **kw)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    for k in ("nodes", "targets", "hop", "drnl", "size"):
        t[k] = t[k].long()
    if packed:
        j["adj_bits"] = jnp.asarray(pack_bits(t["adj"]).numpy())
        t["adj_bits"], t["adj"] = pack_bits(t["adj"]), None
    return jcfg, tcfg, ([JBatch(**j)], [jnp.asarray(feat)]), TBatch(**t), feat


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _perturbed(params, seed=4):
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        tree, [p + 0.1 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])


def _convert(jcfg, tree):
    return params_from_flax(_np_tree(tree), aggr=jcfg.aggr,
                            layer_norm=jcfg.layer_norm)


def _jax_run(jcfg, args, precision="float32"):
    jm = jmodel.DeepGNN(jcfg)
    params = _perturbed(jm.init({"params": jax.random.PRNGKey(0)}, *args,
                                mode_train=True, train=False))

    def lf(p):
        lg, _ = jm.apply(p, *args, mode_train=True, train=True)
        return j_wloss(jcfg, lg, jnp.asarray(LABELS), jnp.asarray(W))

    with jax.default_matmul_precision(precision):
        logits, emb = jm.apply(params, *args, mode_train=False, train=False)
        loss, grads = jax.value_and_grad(lf)(params)
    return params, dict(logits=np.asarray(logits), emb=np.asarray(emb[0]),
                        loss=float(loss),
                        grads={k: v.numpy() for k, v in _convert(jcfg, grads).items()})


def _torch_run(tcfg, sd, batch, feat):
    tm = tmodel.DeepGNN(tcfg)
    tm.load_state_dict(sd)
    with torch.no_grad():
        logits, emb = tm.eval()(batch, torch.as_tensor(feat))
    lg, _ = tm.train()(batch, torch.as_tensor(feat), torch.Generator().manual_seed(0),
                       0, True)
    loss = t_wloss(tcfg, lg, torch.as_tensor(LABELS), torch.as_tensor(W))
    loss.backward()
    return dict(logits=logits.numpy(), emb=emb[0].numpy(), loss=loss.item(),
                grads={k: p.grad.numpy() for k, p in tm.named_parameters()})


def _assert_f32(got, want):
    for k in ("logits", "emb"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(want["grads"])
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("aggr", NEW)
def test_backbone_model_matches_jax(aggr):
    jcfg, tcfg, args, batch, feat = _case(aggr)
    params, want = _jax_run(jcfg, args)
    _assert_f32(_torch_run(tcfg, _convert(jcfg, params), batch, feat), want)


@pytest.mark.parametrize("aggr", ["sage", "gcn", "gin", "gat", "gatscat", "sign"])
def test_pairnorm_model_matches_jax(aggr):
    jcfg, tcfg, args, batch, feat = _case(aggr, layer_norm="pairnorm")
    params, want = _jax_run(jcfg, args)
    _assert_f32(_torch_run(tcfg, _convert(jcfg, params), batch, feat), want)


@pytest.mark.parametrize("aggr", ["gcn", "gin"])
def test_packed_backbone_matches_jax(aggr, monkeypatch):
    """GCN and GIN on packed batches: JAX's packed path (interpret-mode
    Pallas kernel and its transposed VJP) against the port's
    ``packed_spmm`` in the backbone's norm, once per layer."""
    norms = []
    orig = tmodel.packed_spmm
    monkeypatch.setattr(tmodel, "packed_spmm", lambda *a, **kw: (
        norms.append(kw["norm"]), orig(*a, **kw))[1])
    jcfg, tcfg, args, batch, feat = _case(aggr, packed=True)
    assert tcfg.reads_packed_bits and batch.adj is None
    params, want = _jax_run(jcfg, args)
    _assert_f32(_torch_run(tcfg, _convert(jcfg, params), batch, feat), want)
    assert norms == [tmodel.PACKED_NORM[aggr]] * 4      # 2 layers, 2 forwards


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16_witness(jcfg, args, monkeypatch):
    """The JAX model's logits, embeddings, loss and gradients with every
    product at bf16 precision, as the TPU computes it: each f32 operand
    of each ``dot_general``, the forward's and the backward's, rounded
    to bf16 (the forward rounding taken as the identity in the
    gradient), the products summed in f32.  JAX on the CPU ignores
    ``default_matmul_precision``, so the products are wrapped, and run
    without jit, so that no product traced unwrapped is reused."""
    from jax._src.lax import lax as jlax
    dot_general, einsum = jlax.dot_general, jnp.einsum

    def rounded(x):
        if x.dtype != jnp.float32:
            return x
        return x + jax.lax.stop_gradient(
            x.astype(jnp.bfloat16).astype(jnp.float32) - x)

    def bf16_dot_general(lhs, rhs, *a, **kw):
        return dot_general(rounded(lhs), rounded(rhs), *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(jlax, "dot_general", bf16_dot_general)
        m.setattr(jnp, "einsum", lambda *a, **kw: einsum(
            *a, _dot_general=bf16_dot_general, **kw))
        with jax.disable_jit():
            return _jax_run(jcfg, args, "bfloat16")[1]


@pytest.mark.parametrize("aggr,packed", [(a, False) for a in NEW]
                         + [("gcn", True), ("gin", True)])
def test_backbone_model_bf16_precision(aggr, packed, monkeypatch):
    """matmul_precision bfloat16 (every linear, GATScatter's affine maps
    and its attention at the bf16 levels, the packed kernel's bf16 mode):
    logits, embeddings, loss and every gradient within 2e-2 of the
    largest value of flax under ``jax.default_matmul_precision`` and of
    the port's f32 model; the rounding does act.  GIN is also held at
    2e-2 against JAX's GIN with every product rounded to bf16
    (``_bf16_witness``), and its gradients against the f32 references
    at 4e-2: each layer chains two rounded linears after an unnormalised
    sum, whose common component the norm's centring then cancels, and
    the witness drifts from f32 as far as the port does (2.92e-2 at
    most, both; the port's gradients equal the witness's to 3.6e-7).  A smooth
    readout (sum residue, mean pooling): a max readout sends each
    gradient to an argmax that a rounding can move
    (tests/test_torch_bf16_model.py)."""
    jcfg, tcfg, args, batch, feat = _case(aggr, "elu", packed, "bfloat16",
                                          residue="sum", pooling="mean")
    params, want = _jax_run(jcfg, args, "bfloat16")
    sd = _convert(jcfg, params)
    got = _torch_run(tcfg, sd, batch, feat)
    f32 = _torch_run(dataclasses.replace(tcfg, matmul_precision="float32"), sd,
                     batch, feat)
    refs = [(want, BF16_TOL), (f32, BF16_TOL)]
    if aggr == "gin":
        wit = _bf16_witness(jcfg, args, monkeypatch)
        assert _rel(wit["logits"], want["logits"]) > 1e-6     # it does round
        refs = [(want, 2 * BF16_TOL), (f32, 2 * BF16_TOL), (wit, BF16_TOL)]
    for ref, tol_grad in refs:
        for k in ("logits", "emb"):
            assert _rel(got[k], ref[k]) <= BF16_TOL, k
        assert abs(got["loss"] - ref["loss"]) <= BF16_TOL * abs(ref["loss"])
        assert set(got["grads"]) == set(ref["grads"])
        for k in ref["grads"]:
            assert _rel(got["grads"][k], ref["grads"][k]) <= tol_grad, k
    assert _rel(got["logits"], f32["logits"]) > 1e-6


def test_hops_pprs_concat_model_matches_jax():
    """The ``hops-pprs`` augments, concatenated (their linears to dim),
    on a GCN: the PPR one-hot of scores in [0, 1.2)."""
    jcfg, tcfg, args, batch, feat = _case("gcn", feature_augment=("hops", "pprs"),
                                          feature_augment_ops="concat")
    params, want = _jax_run(jcfg, args)
    got = _torch_run(tcfg, _convert(jcfg, params), batch, feat)
    _assert_f32(got, want)
    assert got["grads"]["aug.pprs.weight"].shape == (DIM, 1)
    assert np.abs(got["grads"]["aug.pprs.weight"]).max() > 0


@pytest.mark.parametrize("aggr", ["sage", "gcn", "gin", "gat", "gatscat", "mlp",
                                  "sgc", "sign"])
def test_padding_invariance(aggr):
    """Growing the padding (5 more empty slots a subgraph) does not change
    the logits (tests/test_layers.py:test_model_padding_invariance)."""
    _, tcfg, _, batch, feat = _case(aggr, "relu", layer_norm="pairnorm"
                                    if aggr in ("gcn", "gatscat") else "norm_feat")
    m = tmodel.DeepGNN(tcfg).eval()
    tlayers.init_params(m, torch.Generator().manual_seed(1))

    def pad(x, v=0):
        return torch.nn.functional.pad(x, (0, 5), value=v)

    big = dataclasses.replace(
        batch, nodes=pad(batch.nodes, 1000), node_mask=pad(batch.node_mask, False),
        adj=torch.nn.functional.pad(batch.adj, (0, 5, 0, 5)), hop=pad(batch.hop, -1),
        ppr=pad(batch.ppr), drnl=pad(batch.drnl))
    with torch.no_grad():
        out1, _ = m(batch, torch.as_tensor(feat))
        out2, _ = m(big, torch.nn.functional.pad(torch.as_tensor(feat),
                                                 (0, 0, 0, 5)))
    np.testing.assert_allclose(out2.numpy(), out1.numpy(), **TOL)
