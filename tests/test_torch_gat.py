"""PyTorch port: the fused GAT attention (``ops/gat.py``), kernels B2
(forward) and B3 (backward) of ``csrc/gat_attention.cu``.

On the CPU ``gat_attention`` computes its plain versions; they are held
against the JAX package's Pallas kernel ``gat_attention_hm`` (interpret
mode, with its custom VJP) and its dense reference chain, on the same
numpy inputs with the edge-case rows: an empty row, a row whose kept
entries were all dropped, a row whose max lies on a dropped edge and
padded tail rows.  Tolerance rtol 1e-5 / atol 1e-6 forward and rtol
1e-4 / atol 1e-5 for gradients (as tests/test_pallas_gat.py holds the
Pallas kernel): the same f32 arithmetic, summed in another order.
The kernels' host side (launch shapes, limits, the levels' guards) is
tested here; the kernels themselves run only on the card
(``chip_smoke.py``).  The bf16 levels are held against JAX in
``tests/test_torch_bf16_ops.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.ops import pallas_gat as pg
from shadow_gnn_torch.ops import gat as tg

torch.set_num_threads(2)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


def _case(seed, b=2, n=16, h=2, dh=8, dropedge=True):
    """Symmetric blocks with self edges, 3 padded tail rows, an empty row
    (n//3), a row with every entry dropped (n//2) and a row whose max lies
    on a dropped edge (n//4, column 0, a_n[.., 0] large)."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    adj = np.maximum(adj, np.swapaxes(adj, 1, 2))
    np.einsum("bii->bi", adj)[:] = 1.0
    adj[:, n - 3:] = 0.0
    adj[:, :, n - 3:] = 0.0
    adj[:, n // 3] = 0.0
    adj_norm = adj.copy()
    if dropedge:
        adj_norm *= (rng.random(adj.shape) < 0.8).astype(np.float32)
    adj_norm[:, n // 2] = 0.0
    i4 = n // 4
    adj[:, i4, 0] = 1.0
    adj_norm[:, i4, 0] = 0.0
    adj_norm[:, i4, i4] = 1.0
    a_s = (rng.normal(size=(b, h, n)) * 2.0).astype(np.float32)
    a_n = (rng.normal(size=(b, h, n)) * 2.0).astype(np.float32)
    a_n[:, :, 0] = 8.0
    v = rng.normal(size=(b, n, h, dh)).astype(np.float32)
    cot = rng.normal(size=(b, n, h, dh)).astype(np.float32)
    return [a_s, a_n, v, adj_norm, adj], cot


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args, grad=False):
    return [torch.tensor(a, requires_grad=grad and i < 3) for i, a in enumerate(args)]


@pytest.mark.parametrize("b,n,h,dh,dropedge", [(2, 16, 2, 8, True),
                                               (1, 11, 1, 5, False),
                                               (2, 24, 4, 16, True)])
def test_forward_matches_jax(b, n, h, dh, dropedge):
    """Forward against the Pallas kernel (head-major) and the dense
    reference chain; the edge-case rows aggregate to exactly 0."""
    args, _ = _case(b * n + h, b, n, h, dh, dropedge)
    got = tg.gat_attention(*_torch(args)).numpy()
    j = _jax(args)
    want_hm = pg.gat_attention_hm(j[0], j[1], jnp.transpose(j[2], (0, 2, 1, 3)),
                                  j[3], j[4])
    np.testing.assert_allclose(got, np.transpose(np.asarray(want_hm), (0, 2, 1, 3)),
                               **FWD_TOL)
    np.testing.assert_allclose(got, np.asarray(pg.gat_attention_reference(*j)),
                               **FWD_TOL)
    for row in (n // 3, n // 2, n - 1):
        assert not got[:, row].any()
    assert np.abs(got[:, n // 4]).max() > 0


@pytest.mark.parametrize("b,n,h,dh", [(2, 16, 2, 8), (2, 24, 4, 16)])
def test_gradients_match_jax(b, n, h, dh):
    """The three gradients through the port's backward (the plain B3 on
    the CPU) against the Pallas kernel's custom VJP and autodiff of the
    reference chain; autograd of the plain forward agrees too."""
    args, cot = _case(7 * n + h, b, n, h, dh)
    j = _jax(args)

    def loss(fn, *x):
        return (fn(*x, j[3], j[4]) * jnp.asarray(cot)).sum()

    want_vjp = jax.grad(functools.partial(loss, pg.gat_attention),
                        argnums=(0, 1, 2))(*j[:3])
    want_ref = jax.grad(functools.partial(loss, pg.gat_attention_reference),
                        argnums=(0, 1, 2))(*j[:3])
    for fn in (tg.gat_attention, tg.gat_attention_plain):
        t = _torch(args, grad=True)
        (fn(*t) * torch.as_tensor(cot)).sum().backward()
        for k, name in enumerate(("att_self", "att_neigh", "values")):
            for want in (want_vjp, want_ref):
                np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(want[k]),
                                           err_msg=name, **GRAD_TOL)


def test_att_self_grad_vanishes():
    """Softmax rows do not change when a row is shifted, so d att_self is
    0 up to rounding: held at an absolute tolerance, not hard-coded."""
    args, cot = _case(3, dropedge=False)
    out = tg.gat_attention_plain(*_torch(args))
    das, dan, _ = tg.gat_attention_bwd_plain(*_torch(args), out,
                                             torch.as_tensor(cot))
    np.testing.assert_allclose(das.numpy(), 0.0, atol=1e-5)
    assert np.abs(dan.numpy()).max() > 1e-2


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("aggr", ["gcn", "sage", "gin", "gat"])
def test_prepare_adj_matches_jax(aggr, p):
    """prepare_adj gives (normalised edge-dropped block, structural block)
    as JAX's does; GAT's first block is the raw 0/1 block with dropped
    edges zeroed (adj_gat_drop).  JAX gets the port's dropedge mask."""
    from shadow_gnn_tpu.ops import normalize as jnorm
    from shadow_gnn_torch.ops import normalize as tnorm
    args, _ = _case(11, b=3, n=12)
    adj = args[4]
    seed = 77
    mask = tnorm.dropedge_mask(seed, adj.shape[0], adj.shape[-1], p).numpy()
    orig = jnorm.dropedge_mask
    jnorm.dropedge_mask = lambda rng, a, de: jnp.asarray(mask)
    try:
        want = jnorm.prepare_adj(aggr, jnp.asarray(adj), jax.random.PRNGKey(0), p)
    finally:
        jnorm.dropedge_mask = orig
    got = tnorm.prepare_adj(aggr, torch.as_tensor(adj), seed, p)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1].numpy(), adj)
    if aggr == "gat":
        np.testing.assert_array_equal(got[0].numpy(), adj * mask)


@pytest.mark.parametrize("b, n", [(1, 13), (128, 152), (64, 408), (2, tg.MAX_N)])
@pytest.mark.parametrize("dh", [8, 128, 200])
def test_launch_dims(b, n, dh):
    h = 4
    d = tg.launch_dims(b, n, h, dh)
    words = -(-n // 32)
    few = 8 * min(n * n, tg.MIN_SMEM_EDGES)
    # forward: a CTA per (subgraph, head, dh slice), slices of whole float4s;
    # the smallest split that fits two CTAs an SM, else one
    fwd_base = 16 + 16 * n + 4 * (n + 1) + 128 + 4 * n * words
    assert (dh // 4) % d.split == 0 and d.fwd_grid == b * h * d.split
    splits = [c for c in range(1, dh // 4 + 1) if (dh // 4) % c == 0]
    two = [c for c in splits if fwd_base + 4 * n * (dh // c) + few <= tg.SMEM_TWO_PER_SM]
    one = [c for c in splits if fwd_base + 4 * n * (dh // c) + few <= tg.MAX_SMEM]
    assert d.split == (two or one)[0]
    assert d.fwd_smem == fwd_base + 4 * n * (dh // d.split) + 8 * d.fwd_edge_cap
    # backward: a CTA per (subgraph, head); g staged where it fits two an SM
    bwd_base = 16 + 20 * n + 4 * (n + 1) + 128 + 8 * n * words
    assert d.bwd_grid == b * h
    assert d.g_staged == (bwd_base + 4 * n * dh + few <= tg.SMEM_TWO_PER_SM)
    g_bytes = 4 * n * dh if d.g_staged else 0
    assert d.bwd_smem == bwd_base + g_bytes + 8 * d.bwd_edge_cap
    for cap, smem in ((d.fwd_edge_cap, d.fwd_smem), (d.bwd_edge_cap, d.bwd_smem)):
        # the slots fill two CTAs' share of an SM, or one block
        assert cap <= n * n and smem <= tg.MAX_SMEM
        assert cap == n * n or smem + 8 > min(
            b_ for b_ in (tg.SMEM_TWO_PER_SM, tg.MAX_SMEM) if b_ >= smem)
    # pairs of a subgraph's CTAs share its bitmap
    assert d.fwd_cluster == d.bwd_cluster == 2
    assert d.chunks == (1 if dh <= 128 else 2) and d.threads == 512
    # the scratch buffer: N^2 slots a CTA wherever a subgraph could outgrow
    # shared memory
    assert tg.scratch_bytes(d.bwd_grid, n, d.bwd_edge_cap) == (
        0 if d.bwd_edge_cap == n * n else d.bwd_grid * n * n * 8)


def test_launch_dims_shapes():
    # the products shape: B=128, N=152 (k=150), H=4, dh=128: v and g
    # staged, about 3500-4000 edge slots in shared memory, two CTAs an SM
    assert tg.launch_dims(128, 152, 4, 128) == tg.GatLaunch(
        fwd_grid=512, fwd_cluster=2, split=1, fwd_edge_cap=3957, fwd_smem=115708,
        bwd_grid=512, bwd_cluster=2, g_staged=True, bwd_edge_cap=3501,
        bwd_smem=115708, chunks=1, threads=512)
    # papers GAT-3 (N=408, dh=200): g from global memory, v in 5 slices
    d = tg.launch_dims(64, 408, 4, 200)
    assert not d.g_staged and d.split == 5
    # a small block keeps every slot in shared memory; one head alone
    # makes no cluster
    d = tg.launch_dims(32, 16, 1, 8)
    assert d.fwd_edge_cap == d.bwd_edge_cap == 256 and d.bwd_cluster == 1
    # MAX_N is the largest N whose bitmaps fit one block
    assert tg._bwd_base(tg.MAX_N) <= tg.MAX_SMEM < tg._bwd_base(tg.MAX_N + 1)


def test_wrapper_guards():
    args, _ = _case(5)
    t = _torch(args)
    # the bf16 levels run on the CPU as their plain versions; bf16_scores
    # alone is refused, in both directions
    for kw in (dict(bf16=True), dict(bf16=True, bf16_scores=True)):
        assert torch.equal(tg.gat_attention(*t, **kw),
                           tg.gat_attention_plain(*t, **kw))
    with pytest.raises(ValueError, match="bf16_scores requires bf16"):
        tg.gat_attention(*t, bf16_scores=True)
    with pytest.raises(ValueError, match="bf16_scores requires bf16"):
        tg.gat_attention_bwd(*t, t[2], t[2], bf16_scores=True)
    # tensors neither all on the CPU nor on one CUDA device never reach
    # the plain version, in either direction
    with pytest.raises(ValueError, match="CUDA"):
        tg.gat_attention(t[0].to("meta"), *t[1:])
    with pytest.raises(ValueError, match="CUDA"):
        tg.gat_attention_bwd(*t, t[2], t[2].to("meta"))
    # every operand's shape is checked before a kernel could read it
    meta = [x.to("meta") for x in t]
    for k, bad in ((1, meta[1][:, :1]), (4, meta[4][:, :-1]), (3, meta[3][:1])):
        with pytest.raises(ValueError, match="do not match"):
            tg.gat_attention(*meta[:k], bad, *meta[k + 1:])
    with pytest.raises(ValueError, match="do not match"):
        tg.gat_attention_bwd(*meta, meta[2], meta[2][..., :-1])
    # the kernels' limits: dh beyond 256 or not a multiple of 4, N beyond
    # the backward's bitmaps in shared memory
    for b, n, h, dh in ((128, 152, 4, 128), (16, 408, 4, 200), (64, 408, 4, 200),
                        (2, tg.MAX_N, 4, 256), (2, tg.MAX_N, 1, 8)):
        tg.check_limits(b, n, h, dh)
    for b, n, h, dh in ((2, 16, 1, 257), (2, 16, 4, 260), (2, 16, 4, 10),
                        (2, tg.MAX_N + 1, 4, 128), (3, 2920, 4, 128)):
        with pytest.raises(ValueError, match="limits"):
            tg.check_limits(b, n, h, dh)
    # on the CPU nothing counts as a kernel launch, at any level
    counts = [tg.gat_attention.launches, tg.gat_attention_bwd.launches,
              tg.gat_attention.launches_bf16, tg.gat_attention_bwd.launches_bf16]
    for level in (False, True):
        tg_t = _torch(args, grad=True)
        tg.gat_attention(*tg_t, level, level).sum().backward()
    assert counts == [tg.gat_attention.launches, tg.gat_attention_bwd.launches,
                      tg.gat_attention.launches_bf16,
                      tg.gat_attention_bwd.launches_bf16]
