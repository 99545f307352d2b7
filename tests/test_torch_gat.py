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


def test_launch_dims():
    r, warps = tg.ROWS_PER_BLOCK, tg.THREADS // 32
    for b, n in ((1, 13), (128, 152), (64, 408), (2, 2900)):
        grid, threads, smem, tiles, col_grid, col_smem, col_tiles = tg.launch_dims(b, n)
        assert tiles * r >= n > (tiles - 1) * r and grid == b * tiles
        assert col_tiles * 32 >= n > (col_tiles - 1) * 32 and col_grid == b * col_tiles
        assert threads == 32 * warps
        # wv[r*n] f32 | pe[warps*n] f32 | cnt[r] i32 | nbr[r*n] u16
        assert smem == 4 * r * n + 4 * warps * n + 4 * r + 2 * r * n
        assert col_smem == 4 * 32 * -(-n // 32)
        assert smem <= tg.MAX_SMEM
    # the products shape: B=128, N=152 (k=150)
    assert tg.launch_dims(128, 152) == (2432, 256, 12192, 19, 640, 640, 5)
    assert tg.launch_dims(3, 2920)[2] > tg.MAX_SMEM


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
    # the kernels' limits: dh beyond 256 and N beyond the shared memory
    for b, n, dh in ((128, 152, 128), (16, 408, 200), (2, 2900, 256)):
        tg.check_limits(b, n, dh)
    for b, n, dh in ((2, 16, 257), (3, 2920, 128)):
        with pytest.raises(ValueError, match="limits"):
            tg.check_limits(b, n, dh)
    # on the CPU nothing counts as a kernel launch, at any level
    counts = [tg.gat_attention.launches, tg.gat_attention_bwd.launches,
              tg.gat_attention.launches_bf16, tg.gat_attention_bwd.launches_bf16]
    for level in (False, True):
        tg_t = _torch(args, grad=True)
        tg.gat_attention(*tg_t, level, level).sum().backward()
    assert counts == [tg.gat_attention.launches, tg.gat_attention_bwd.launches,
                      tg.gat_attention.launches_bf16,
                      tg.gat_attention_bwd.launches_bf16]
