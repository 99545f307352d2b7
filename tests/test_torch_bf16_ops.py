"""PyTorch port, the bf16 precision trade at the operator level: the
bf16-precision products (``ops/precision.py``), the packed aggregation's
bf16 mode (B1c, ``ops/packed.py``) and the GAT attention's bf16 levels
(B2b/B3b, ``ops/gat.py``) on the CPU, where the wrappers compute their
plain versions.

JAX's Pallas kernels run in interpret mode on the CPU and round exactly
where they do on the TPU, so the plain versions are held against them
at f32 tolerances: the same rounded operands, summed in another order.
Where the two sides compute an operand that is then rounded (sym's
``rsqrt``, GAT's ``exp``), a last-bit difference can flip one bf16
rounding; such flips are counted, and the difference they may cause is
bounded instead of loosening every tolerance."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.ops import normalize as jnorm
from shadow_gnn_tpu.ops import pallas_gat as pg
from shadow_gnn_tpu.ops import pallas_packed as jpp
from shadow_gnn_tpu.sampling import cache as jcache
from shadow_gnn_torch.ops import gat as tg
from shadow_gnn_torch.ops import normalize as tnorm
from shadow_gnn_torch.ops import packed as tpp
from shadow_gnn_torch.ops.precision import bf16_head_dot, bf16_matmul, round_bf16

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)       # as tests/test_torch_gat.py


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


def _bf16_np(x):
    """numpy f32 -> bf16 (nearest even, through JAX) -> f32."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------- products

def test_round_bf16_matches_jax():
    """Round to nearest even, ties and subnormals included, bit for bit."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4096).astype(np.float32) * 1e3,
                        np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 1e-39,
                                  3e-41, 0.0, -0.0], np.float32)])
    np.testing.assert_array_equal(round_bf16(torch.as_tensor(x)).numpy(), _bf16_np(x))


@pytest.mark.parametrize("shape", [((7, 33), (33, 5)), ((3, 6, 40), (3, 40, 9))])
def test_bf16_matmul_is_the_product_of_rounded_operands(shape):
    """Forward: the f32 product of the bf16-rounded operands; backward:
    g and the other operand rounded too (JAX's dot VJP at the same
    precision).  On the CPU the same torch product: bit-equal."""
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=s).astype(np.float32) for s in shape)
    ta, tb = (torch.tensor(v, requires_grad=True) for v in (a, b))
    out = bf16_matmul(ta, tb)
    g = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32))
    out.backward(g)
    ra, rb, rg = (round_bf16(torch.as_tensor(v)) for v in (a, b, g))
    assert out.dtype == torch.float32
    assert torch.equal(out, torch.matmul(ra, rb))
    assert torch.equal(ta.grad, torch.matmul(rg, rb.transpose(-1, -2)))
    assert torch.equal(tb.grad, torch.matmul(ra.transpose(-1, -2), rg))
    # and the rounding matters: the f32 product differs
    assert not torch.equal(out, torch.matmul(torch.as_tensor(a), torch.as_tensor(b)))


def test_bf16_head_dot_matches_jax_rounded_einsum():
    """GAT's attention-vector contraction at bf16 precision, forward and
    both gradients, against JAX's einsum of the rounded operands."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    a = rng.normal(size=(3, 8)).astype(np.float32)
    g = rng.normal(size=(2, 3, 5)).astype(np.float32)
    r = _bf16_np

    def jf(xx, aa):
        return jnp.einsum("bnhd,hd->bhn", xx, aa,
                          precision=jax.lax.Precision.HIGHEST)

    want, vjp = jax.vjp(jf, jnp.asarray(r(x)), jnp.asarray(r(a)))
    gx, ga = vjp(jnp.asarray(r(g)))
    tx, ta = torch.tensor(x, requires_grad=True), torch.tensor(a, requires_grad=True)
    out = bf16_head_dot(tx, ta)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), **TOL)


# ---------------------------------------------------------------- B1c

def _packed_case(n, b=3, f=8, seed=0):
    rng = np.random.default_rng(seed + n)
    adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    adj[:, n // 2] = 0.0                          # an empty row
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    g = rng.normal(size=(b, n, f)).astype(np.float32)
    return adj, x, g


def _port_block(norm, adj, seed=0, p=0.0):
    fn = {"none": tnorm.adj_drop, "rw": tnorm.adj_norm_rw,
          "sym": tnorm.adj_norm_sym, "gin": tnorm.adj_gin_rescale}[norm]
    return round_bf16(fn(torch.as_tensor(adj), seed, p)).numpy()


@pytest.mark.parametrize("n", [13, 24, 37])
@pytest.mark.parametrize("norm", ["none", "rw", "sym", "gin"])
def test_packed_spmm_bf16_matches_pallas(norm, n):
    """B1c at dropedge 0, forward and the x-gradient (the transposed
    product, which carries the mode), against the interpret-mode Pallas
    kernel ``packed_spmm(..., bf16=True)`` and its custom VJP.

    none/rw/gin: rtol 1e-5 / atol 1e-6 (the normalised entries are exact
    quotients on both sides, so the rounded operands are equal).  sym:
    each entry is bf16(r_i * r_j) with r = rsqrt(deg), and torch's rsqrt
    may differ from XLA's in the last bit; the entries whose rounding
    flips are counted (at most 1% of them, each one bf16 ulp apart), and
    the outputs are held at the same tolerance plus the bound those
    flips allow, |dW| @ |x|."""
    adj, x, g = _packed_case(n)
    bits = np.array(jcache.pack_bits(jnp.asarray(adj)))
    want, vjp = jax.vjp(lambda xx: jpp.packed_spmm(jnp.asarray(bits), xx, 0, norm,
                                                   0.0, True), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    out = tpp.packed_spmm(torch.as_tensor(bits), tx, norm, bf16=True)
    out.backward(torch.as_tensor(g))
    w_port = _port_block(norm, adj)
    w_jax = np.stack([_bf16_np(jpp._norm_adj(jnp.asarray(a), norm, 0.0, None, None))
                      for a in adj])
    flips = w_port != w_jax
    slack = np.zeros_like(x), np.zeros_like(x)
    if norm != "sym":
        assert not flips.any()
    else:
        assert flips.sum() <= 0.01 * (adj > 0).sum()
        dw = np.abs(w_port - w_jax)
        assert (dw <= 2**-7 * np.abs(w_jax)).all()          # one bf16 ulp
        slack = (dw @ np.abs(_bf16_np(x)),
                 np.swapaxes(dw, 1, 2) @ np.abs(_bf16_np(g)))
    for got, ref, s in ((out.detach().numpy(), np.asarray(want), slack[0]),
                        (tx.grad.numpy(), np.asarray(want_dx), slack[1])):
        assert (np.abs(got - ref) <= TOL["atol"] + TOL["rtol"] * np.abs(ref)
                + 1.001 * s).all()
    # the mode rounds: the f32 kernel gives another answer
    assert not np.allclose(np.asarray(want),
                           np.asarray(jpp.packed_spmm(jnp.asarray(bits),
                                                      jnp.asarray(x), 0, norm, 0.0)),
                           rtol=1e-5, atol=1e-6)


def _jax_dense(norm, adj, mask, p):
    """JAX's dense normalisation under dropedge p, with the port's mask
    handed in where JAX would draw its own."""
    fn = {"none": jnorm.adj_gat_drop, "rw": jnorm.adj_norm_rw,
          "sym": jnorm.adj_norm_sym, "gin": jnorm.adj_gin_rescale}[norm]
    orig = jnorm.dropedge_mask
    jnorm.dropedge_mask = lambda rng, a, de: jnp.asarray(mask)
    try:
        return np.asarray(fn(jnp.asarray(adj), jax.random.PRNGKey(0), p))
    finally:
        jnorm.dropedge_mask = orig


@pytest.mark.parametrize("n", [13, 37])
@pytest.mark.parametrize("norm", ["none", "rw", "sym", "gin"])
def test_packed_spmm_bf16_under_dropedge_matches_jax(norm, n):
    """B1c at dropedge 0.3: the forward and the x-gradient against JAX's
    dense formulas under the port's mask, rounded to bf16 as the kernel
    rounds them, in f32 products (HIGHEST precision).  Flips as above."""
    p, seed = 0.3, 4321 + n
    adj, x, g = _packed_case(n)
    mask = tnorm.dropedge_mask(seed, adj.shape[0], n, p).numpy()
    w_jax = _bf16_np(_jax_dense(norm, adj, mask, p))
    w_port = _port_block(norm, adj, seed, p)
    flips = w_port != w_jax
    assert flips.sum() <= (0 if norm != "sym" else 0.01 * (adj > 0).sum())

    def jf(xx):
        return jnp.einsum("bij,bjf->bif", w_jax, xx, precision=jax.lax.Precision.HIGHEST)

    want, vjp = jax.vjp(jf, jnp.asarray(_bf16_np(x)))
    (want_dx,) = vjp(jnp.asarray(_bf16_np(g)))
    tbits = torch.as_tensor(np.array(jcache.pack_bits(jnp.asarray(adj))))
    tx = torch.tensor(x, requires_grad=True)
    out = tpp.packed_spmm(tbits, tx, norm, p, seed, bf16=True)
    out.backward(torch.as_tensor(g))
    dw = np.abs(w_port - w_jax)
    for got, ref, s in ((out.detach().numpy(), np.asarray(want),
                         dw @ np.abs(_bf16_np(x))),
                        (tx.grad.numpy(), np.asarray(want_dx),
                         np.swapaxes(dw, 1, 2) @ np.abs(_bf16_np(g)))):
        assert (np.abs(got - ref) <= TOL["atol"] + TOL["rtol"] * np.abs(ref)
                + 1.001 * s).all()


@pytest.mark.parametrize("norm", ["rw", "sym"])
def test_packed_spmm_bf16_backward_is_its_transposed_product(norm):
    """Autograd's backward of the bf16 forward is packed_spmm_t in the
    bf16 mode under the same seed (so g is rounded, unlike autograd
    through the rounded plain forward)."""
    adj, x, g = _packed_case(24, b=4)
    tbits = torch.as_tensor(np.array(jcache.pack_bits(jnp.asarray(adj))))
    tx = torch.tensor(x, requires_grad=True)
    tpp.packed_spmm(tbits, tx, norm, 0.5, 77, bf16=True).backward(torch.as_tensor(g))
    assert torch.equal(tx.grad, tpp.packed_spmm_t(tbits, torch.as_tensor(g), norm,
                                                  0.5, 77, bf16=True))
    assert not torch.equal(tx.grad, tpp.packed_spmm_t(tbits, torch.as_tensor(g),
                                                      norm, 0.5, 77))


# ---------------------------------------------------------------- B2b/B3b

def _gat_case(seed, b=2, n=16, h=2, dh=8):
    """The blocks of tests/test_torch_gat.py: symmetric, with self edges,
    3 padded tail rows, an empty row (n//3), a row with every entry
    dropped (n//2) and a row whose max lies on a dropped edge (n//4)."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    adj = np.maximum(adj, np.swapaxes(adj, 1, 2))
    np.einsum("bii->bi", adj)[:] = 1.0
    adj[:, n - 3:] = 0.0
    adj[:, :, n - 3:] = 0.0
    adj[:, n // 3] = 0.0
    adj_norm = adj * (rng.random(adj.shape) < 0.8).astype(np.float32)
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


LEVELS = [dict(bf16=True, bf16_scores=False), dict(bf16=True, bf16_scores=True)]


def _exp_flips(args, scores):
    """Entries where bf16(exp(bf16(S - rm))) differs between torch and
    XLA on the CPU (0 when the level does not round the scores)."""
    if not scores:
        return 0
    a_s, a_n, _, _, adj = args
    s = a_s[..., :, None] + a_n[..., None, :]
    s_m = np.where(adj[:, None] > 0, s, -np.inf)
    rm = s_m.max(-1, keepdims=True)
    rm = np.where(np.isfinite(rm), rm, 0.0).astype(np.float32)
    xr = _bf16_np(s_m - rm)
    jx = _bf16_np(np.asarray(jnp.exp(jnp.asarray(xr, jnp.bfloat16)).astype(jnp.float32)))
    tx = round_bf16(torch.exp(torch.from_numpy(xr.copy()))).numpy()
    return int((jx != tx).sum())


@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("b,n,h,dh", [(2, 16, 2, 8), (2, 24, 4, 16)])
def test_gat_bf16_levels_match_pallas(b, n, h, dh, level, vdtype):
    """B2b and B3b on the CPU (the plain versions behind gat_attention)
    against the interpret-mode Pallas kernel ``gat_attention_hm`` and its
    custom VJP at the same level, on f32 and on bf16 values: the forward
    and the three gradients, at the f32 tolerances of
    tests/test_torch_gat.py (rtol 1e-5 / atol 1e-6 forward, rtol 1e-4 /
    atol 1e-5 gradients).  The edge-case rows aggregate to exactly 0, and
    dv comes back in the values' dtype.  XLA's exp of a bf16 argument
    and torch's may round differently; no such flip occurs on these
    inputs (counted and asserted)."""
    kw = LEVELS[level]
    args, cot = _gat_case(31 * n + 7 * h + level, b, n, h, dh)
    jdt = jnp.bfloat16 if vdtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if vdtype == "bfloat16" else torch.float32
    assert _exp_flips(args, kw["bf16_scores"]) == 0
    j = [jnp.asarray(a) for a in args]
    jv = jnp.transpose(j[2], (0, 2, 1, 3)).astype(jdt)

    def jf(a_s, a_n, v):
        return pg.gat_attention_hm(a_s, a_n, v, j[3], j[4], kw["bf16"],
                                   kw["bf16_scores"])

    want, vjp = jax.vjp(jf, j[0], j[1], jv)
    want_g = vjp(jnp.transpose(jnp.asarray(cot), (0, 2, 1, 3)))
    t = [torch.tensor(a, requires_grad=i < 3) for i, a in enumerate(args)]
    tv = t[2].detach().to(tdt).requires_grad_()
    out = tg.gat_attention(t[0], t[1], tv, t[3], t[4], **kw)
    out.backward(torch.as_tensor(cot))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.transpose(np.asarray(want), (0, 2, 1, 3)), **TOL)
    assert tv.grad.dtype == tdt and want_g[2].dtype == jdt
    for got, ref, name in ((t[0].grad, want_g[0], "att_self"),
                           (t[1].grad, want_g[1], "att_neigh"),
                           (tv.grad.float(), np.transpose(
                               np.asarray(want_g[2].astype(jnp.float32)), (0, 2, 1, 3)),
                            "values")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=name,
                                   **GRAD_TOL)
    for row in (n // 3, n // 2, n - 1):
        assert not out.detach()[:, row].any()
    # the level rounds: the f32 attention gives another answer
    f32 = tg.gat_attention_plain(*[x.detach() for x in t[:2]], tv.detach(), t[3], t[4])
    assert not torch.allclose(out.detach(), f32, rtol=1e-5, atol=1e-6)


def test_gat_bf16_backward_is_the_levels_vjp():
    """The backward at a bf16 level is the plain B3b (g, P and v rounded
    where they enter a product, ds from the unrounded P), not autograd
    through the rounded plain forward."""
    args, cot = _gat_case(5)
    t = [torch.tensor(a, requires_grad=i < 3) for i, a in enumerate(args)]
    out = tg.gat_attention(*t, bf16=True, bf16_scores=True)
    out.backward(torch.as_tensor(cot))
    want = tg.gat_attention_bwd_plain(*[x.detach() for x in t], out.detach(),
                                      torch.as_tensor(cot), True, True)
    for got, ref in zip((t[0].grad, t[1].grad, t[2].grad), want):
        assert torch.equal(got, ref)
    t2 = [torch.tensor(a, requires_grad=i < 3) for i, a in enumerate(args)]
    tg.gat_attention_plain(*t2, True, True).backward(torch.as_tensor(cot))
    assert not torch.equal(t2[2].grad, t[2].grad)
