"""PyTorch port, the bf16 precision trade at the model level: DeepGNN
(SAGE-3 dense and packed, GAT-2) under ``matmul_precision="bfloat16"``
and under ``compute_dtype="bfloat16"`` against the JAX package's flax
model, under the same weights (``params_from_flax``).

JAX on the CPU computes its XLA products in f32 whatever
``jax.default_matmul_precision`` says; only its Pallas kernels (interpret
mode) round to bf16.  The port rounds every product.  So under
``matmul_precision="bfloat16"`` the two differ by the bf16 rounding of
the linears' operands: held at 2e-2 of the largest value (as
tests/test_pallas_gat.py holds bf16 against f32), and so is the port's
own f32 model.  The gradients are held on smooth activations (elu): a
rounding moves a pre-activation by up to 2^-9 of itself, enough to move
an input near 0 across relu's or prelu's kink, where the gradient
jumps.

``compute_dtype="bfloat16"`` follows JAX's type promotion: a model with
label inputs or the hop augment returns its block to f32 at the select
or the add, so it matches JAX at the f32 tolerances of
tests/test_torch_model.py; a GAT without either carries bf16 values into
the attention (its bf16 levels), held at 1e-2 of the largest logit (a
few bf16 ulps, 2^-8 each) and 5e-2 of the largest gradient (bf16
backward products, rounded at other points by XLA and torch)."""
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
B, N, F, DIM, C, D_LAB = 4, 24, 16, 32, 5, 6
BF16_TOL = 2e-2


def _batch_arrays(seed, gat):
    """A random padded batch (tests/test_torch_model.py's): sorted ids,
    symmetric 0/1 blocks over the valid rows (with self edges for GAT),
    hops with out-of-range values."""
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
    if gat:
        np.einsum("bii->bi", adj)[:] = mask
    targets = np.array([[rng.integers(s)] for s in sizes], np.int32)
    hop = np.where(mask, rng.integers(-1, 8, (B, N)), -1).astype(np.int32)
    feat = rng.normal(size=(B, N, F)).astype(np.float32)
    return dict(nodes=nodes, node_mask=mask, adj=adj, targets=targets,
                size=sizes.astype(np.int32), hop=hop,
                ppr=np.zeros((B, N), np.float32),
                drnl=np.zeros((B, N), np.int32)), feat


def _jax_batch(a, packed):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if packed:
        j["adj_bits"] = jnp.asarray(pack_bits(torch.as_tensor(a["adj"])).numpy())
    return JBatch(**j)


def _torch_batch(a, packed):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    for k in ("nodes", "targets", "hop", "drnl", "size"):
        t[k] = t[k].long()
    if packed:
        t["adj_bits"], t["adj"] = pack_bits(t["adj"]), None
    return TBatch(**t)


def _case(kind, act, labels=True, **extra):
    """(jax cfg, torch cfg, jax batch args, torch batch, feat): SAGE-3
    (hop augment) or GAT-2 (2 heads, max residue and pooling; with label
    inputs and the hop augment unless ``labels`` is False)."""
    gat = kind == "gat"
    a, feat = _batch_arrays(5, gat)
    packed = kind == "sage_packed"
    if gat:
        d_lab = D_LAB if labels else 0
        if labels:
            lab = np.random.default_rng(6).random((B, N, D_LAB)).astype(np.float32)
            feat = np.concatenate([feat, lab], -1)
        kw = dict(dim_feat_smooth=F, dim_label_raw=C, dim_label_smooth=d_lab,
                  aggr="gat", num_layers=2, dim=DIM, heads=2, act=act,
                  residue="max", pooling="max",
                  feature_augment=("hops",) if labels else ())
        jcfg = jmodel.ModelConfig(dim_feat_raw=F, fused_gat=True, **kw)
    else:
        kw = dict(dim_feat_smooth=F, dim_label_raw=C, dim_label_smooth=0,
                  aggr="sage", num_layers=3, dim=DIM, act=act,
                  feature_augment=("hops",), packed_adj=packed)
        jcfg = jmodel.ModelConfig(dim_feat_raw=F, **kw)
    jcfg = dataclasses.replace(jcfg, compute_dtype=extra.get("compute_dtype",
                                                             "float32"))
    tcfg = tmodel.ModelConfig(**kw, **extra)
    # a model that takes the dense path gets the dense block
    return (jcfg, tcfg, ([_jax_batch(a, packed)], [jnp.asarray(feat)]),
            _torch_batch(a, packed and tcfg.reads_packed_bits), feat)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _perturbed(params, seed=4):
    return jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(seed), p.shape),
        params)


LABELS = np.random.default_rng(2).integers(0, C, B)
W = np.array([1, 1, 0, 1], np.float32)          # a padding row


def _jax_run(jcfg, args, precision):
    """flax eval logits and embedding, and the training-mode (dropout 0)
    loss and gradients, under ``jax.default_matmul_precision``."""
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
                        grads={k: v.numpy() for k, v in
                               params_from_flax(_np_tree(grads)).items()})


def _torch_run(tcfg, params, batch, feat):
    tm = tmodel.DeepGNN(tcfg)
    tm.load_state_dict(params_from_flax(_np_tree(params)))
    with torch.no_grad():
        logits, emb = tm.eval()(batch, torch.as_tensor(feat))
    lg, _ = tm.train()(batch, torch.as_tensor(feat), torch.Generator().manual_seed(0),
                       0, True)
    loss = t_wloss(tcfg, lg, torch.as_tensor(LABELS), torch.as_tensor(W))
    loss.backward()
    return dict(logits=logits.numpy(), emb=emb[0].numpy(), loss=loss.item(),
                grads={k: p.grad.float().numpy() for k, p in tm.named_parameters()})


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _grad_err(got, want):
    assert set(got) == set(want)
    return max((_rel(got[k], want[k]), k) for k in want)


@pytest.mark.parametrize("kind,act", [("sage", "relu"), ("sage_packed", "relu"),
                                      ("gat", "prelu")])
def test_matmul_precision_bf16_forward_matches_jax(kind, act):
    """Logits, embeddings and the training-mode loss at bf16 precision
    against flax under ``jax.default_matmul_precision("bfloat16")`` and
    against the port's f32 model, within 2e-2 of the largest value; the
    rounding does act (the bf16 and f32 logits differ)."""
    jcfg, tcfg, args, batch, feat = _case(kind, act, matmul_precision="bfloat16")
    params, want = _jax_run(jcfg, args, "bfloat16")
    got = _torch_run(tcfg, params, batch, feat)
    f32 = _torch_run(dataclasses.replace(tcfg, matmul_precision="float32"), params,
                     batch, feat)
    for ref in (want, f32):
        for k in ("logits", "emb"):
            assert _rel(got[k], ref[k]) <= BF16_TOL, k
        assert abs(got["loss"] - ref["loss"]) <= BF16_TOL * abs(ref["loss"])
    assert _rel(got["logits"], f32["logits"]) > 1e-5
    if kind == "sage":
        # no kernel on JAX's dense path: JAX-CPU's answer is the f32 one
        np.testing.assert_allclose(f32["logits"], want["logits"], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["sage", "sage_packed", "gat"])
def test_matmul_precision_bf16_gradients_match_jax(kind):
    """Every parameter's gradient at bf16 precision, within 2e-2 of its
    largest entry, against flax and against the port's f32 model, on the
    smooth elu activation (module docstring) and, for GAT, a smooth
    readout (concat residue, center pooling): a max readout sends each
    gradient to an argmax, and one argmax that the rounding moves (seen:
    1 of 512 in a training forward) moves a weight's gradient by up to a
    third of its max."""
    jcfg, tcfg, args, batch, feat = _case(kind, "elu", matmul_precision="bfloat16")
    if kind == "gat":
        smooth = dict(residue="concat", pooling="center")
        jcfg = dataclasses.replace(jcfg, **smooth)
        tcfg = dataclasses.replace(tcfg, **smooth)
    params, want = _jax_run(jcfg, args, "bfloat16")
    got = _torch_run(tcfg, params, batch, feat)
    f32 = _torch_run(dataclasses.replace(tcfg, matmul_precision="float32"), params,
                     batch, feat)
    for ref in (want, f32):
        err, name = _grad_err(got["grads"], ref["grads"])
        assert err <= BF16_TOL, name


def test_matmul_precision_bf16_runs_the_kernels_bf16_levels(monkeypatch):
    """At bf16 precision the packed aggregation runs its bf16 mode and
    GAT its bf16 + bf16_scores levels on f32 values (layers.py:501-508)."""
    seen = []
    orig_attn = tlayers.gat_attention
    monkeypatch.setattr(tlayers, "gat_attention", lambda *a: (
        seen.append(("gat", a[2].dtype, a[5:])), orig_attn(*a))[1])
    orig_packed = tmodel.packed_spmm
    monkeypatch.setattr(tmodel, "packed_spmm", lambda *a, **kw: (
        seen.append(("packed", kw["bf16"])), orig_packed(*a, **kw))[1])
    for kind, act in (("sage_packed", "relu"), ("gat", "prelu")):
        _, tcfg, _, batch, feat = _case(kind, act, matmul_precision="bfloat16")
        m = tmodel.DeepGNN(tcfg).eval()
        with torch.no_grad():
            m(batch, torch.as_tensor(feat))
    assert seen == [("packed", True)] * 3 + [("gat", torch.float32, (True, True))] * 2


@pytest.mark.parametrize("kind,act", [("sage", "relu"), ("sage_packed", "relu"),
                                      ("gat", "prelu")])
def test_compute_dtype_bf16_matches_jax(kind, act):
    """compute_dtype bfloat16 on the two ported models' kinds: the
    features (and SAGE's dense block) are rounded to bf16, then the
    hop-augment add (SAGE) or the label-input select (GAT) returns the
    block to f32, as JAX's promotion does: logits, embeddings, loss and
    gradients at the f32 tolerances (rtol 1e-4 / atol 1e-5).  The packed
    model takes the dense path."""
    jcfg, tcfg, args, batch, feat = _case(kind, act, compute_dtype="bfloat16")
    assert not tcfg.reads_packed_bits and batch.adj is not None
    params, want = _jax_run(jcfg, args, "highest")
    got = _torch_run(tcfg, params, batch, feat)
    for k in ("logits", "emb"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for k in want["grads"]:
        np.testing.assert_allclose(got["grads"][k], want["grads"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the rounding of the inputs acts: the f32 model answers otherwise
    f32 = _torch_run(dataclasses.replace(tcfg, compute_dtype="float32"), params,
                     batch, feat)
    assert _rel(got["logits"], f32["logits"]) > 1e-6


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_compute_dtype_bf16_gat_values_match_jax(monkeypatch, precision):
    """A GAT without label inputs or augment keeps bf16 activations: the
    attention gets bf16 values at its bf16 levels and its output is cast
    back to bf16.  Against flax at compute_dtype bfloat16 (module
    docstring's bf16 tolerances)."""
    seen = []
    orig = tlayers.gat_attention
    monkeypatch.setattr(tlayers, "gat_attention", lambda *a: (
        seen.append((a[2].dtype, a[5:])), orig(*a))[1])
    jcfg, tcfg, args, batch, feat = _case("gat", "relu", labels=False,
                                          compute_dtype="bfloat16",
                                          matmul_precision=precision)
    params, want = _jax_run(jcfg, args, precision)
    got = _torch_run(tcfg, params, batch, feat)
    assert seen and all(s == (torch.bfloat16, (True, True)) for s in seen)
    for k in ("logits", "emb"):
        assert _rel(got[k], want[k]) <= 1e-2, k
    assert abs(got["loss"] - want["loss"]) <= 1e-2 * abs(want["loss"])
    err, name = _grad_err(got["grads"], want["grads"])
    assert err <= 5e-2, name


def test_params_stay_f32_under_the_trade():
    """params_from_flax needs no change: a flax model at compute_dtype
    bfloat16 has f32 parameters of the f32 model's names and shapes, and
    they load into the port's bf16 model as f32."""
    for kind, act in (("sage", "relu"), ("gat", "prelu")):
        jcfg, tcfg, args, _, _ = _case(kind, act, compute_dtype="bfloat16",
                                       matmul_precision="bfloat16")
        p16 = jmodel.DeepGNN(jcfg).init({"params": jax.random.PRNGKey(0)}, *args,
                                        mode_train=False, train=False)
        p32 = jmodel.DeepGNN(dataclasses.replace(jcfg, compute_dtype="float32")).init(
            {"params": jax.random.PRNGKey(0)}, *args, mode_train=False, train=False)
        sd16, sd32 = (params_from_flax(_np_tree(p)) for p in (p16, p32))
        assert {k: (v.shape, v.dtype) for k, v in sd16.items()} == {
            k: (v.shape, v.dtype) for k, v in sd32.items()}
        assert all(v.dtype == torch.float32 for v in sd16.values())
        tm = tmodel.DeepGNN(tcfg)
        tm.load_state_dict(sd16)
        assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_config_guards():
    _, tcfg, _, _, _ = _case("sage_packed", "relu")
    assert tcfg.reads_packed_bits
    assert not dataclasses.replace(tcfg, compute_dtype="bfloat16").reads_packed_bits
    assert dataclasses.replace(tcfg, matmul_precision="bfloat16").reads_packed_bits
    # TF32 precision reads the packed bits too, in the kernel's bf16 mode
    t32 = dataclasses.replace(tcfg, matmul_precision="tensorfloat32")
    assert t32.reads_packed_bits and tmodel.DeepGNN(t32).cfg is t32
    for bad in (dict(matmul_precision="float16"), dict(compute_dtype="float16")):
        with pytest.raises(ValueError):
            tmodel.DeepGNN(dataclasses.replace(tcfg, **bad))
