"""PyTorch port: bit packing, the packed aggregation and its transposed
backward against the JAX package (Pallas kernel in interpret mode on
the CPU at dropedge 0; JAX's dense formulas under the port's dropedge
mask otherwise), the dropedge mask, the kernel wrapper's guards and
launch arithmetic, and the port's isolation from JAX."""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.ops import normalize as jnorm
from shadow_gnn_tpu.ops import pallas_packed as jpp
from shadow_gnn_tpu.sampling import cache as jcache
from shadow_gnn_torch.ops import normalize as tnorm
from shadow_gnn_torch.ops import packed as tpp
from shadow_gnn_torch.sampling import cache as tcache
from shadow_gnn_torch.train.pipeline import resolve_device

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(n, b=3, f=8, seed=0):
    rng = np.random.default_rng(seed + n)
    adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    adj[:, n // 2] = 0.0                          # an empty row
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    return adj, x


@pytest.mark.parametrize("n", [13, 24, 37, 208])
def test_pack_unpack_bytes_equal_jax(n):
    adj, _ = _case(n)
    want = np.asarray(jcache.pack_bits(jnp.asarray(adj)))
    got = tcache.pack_bits(torch.as_tensor(adj)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the padding bits of the last byte column read back as nothing
    back = tcache.unpack_bits(torch.as_tensor(got), n).numpy()
    np.testing.assert_array_equal(back, adj)
    np.testing.assert_array_equal(
        back, np.asarray(jcache.unpack_bits(jnp.asarray(want), n)))


@pytest.mark.parametrize("n", [13, 24, 37])
@pytest.mark.parametrize("norm", ["none", "rw", "sym", "gin"])
def test_packed_spmm_plain_matches_jax(norm, n):
    """Same sums in another order: atol/rtol 1e-5."""
    adj, x = _case(n)
    bits = np.array(jcache.pack_bits(jnp.asarray(adj)))
    want = np.asarray(jpp.packed_spmm(jnp.asarray(bits), jnp.asarray(x), 0,
                                      norm, 0.0))
    tb, tx = torch.as_tensor(bits), torch.as_tensor(x)
    got = tpp.packed_spmm_plain(tb, tx, norm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors and counts it
    calls, launches = tpp.packed_spmm.calls, tpp.packed_spmm.launches
    np.testing.assert_array_equal(tpp.packed_spmm(tb, tx, norm).numpy(), got)
    assert tpp.packed_spmm.calls == calls + 1
    assert tpp.packed_spmm.launches == launches


def _jax_dense(norm, adj, mask, p):
    """JAX's dense normalisation under dropedge p, with the port's mask
    handed in where JAX would draw its own."""
    fn = {"none": jnorm.adj_gat_drop, "rw": jnorm.adj_norm_rw,
          "sym": jnorm.adj_norm_sym, "gin": jnorm.adj_gin_rescale}[norm]
    orig = jnorm.dropedge_mask
    jnorm.dropedge_mask = lambda rng, a, de: jnp.asarray(mask)
    try:
        return fn(jnp.asarray(adj), jax.random.PRNGKey(0), p)
    finally:
        jnorm.dropedge_mask = orig


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("n", [13, 24, 37])
@pytest.mark.parametrize("norm", ["none", "rw", "sym", "gin"])
def test_packed_spmm_and_grad_match_jax(norm, n, p):
    """Forward and x-gradient (the transposed product) of the port's
    packed_spmm on the CPU against JAX: the interpret-mode Pallas kernel
    and its custom VJP at p=0; the dense formulas under the port's mask
    at p>0.  Same f32 sums in another order: atol/rtol 1e-5."""
    adj, x = _case(n)
    g = np.random.default_rng(n + 100).normal(size=x.shape).astype(np.float32)
    bits = np.array(jcache.pack_bits(jnp.asarray(adj)))
    seed = 1234 + n
    if p == 0.0:
        want, vjp = jax.vjp(lambda xx: jpp.packed_spmm(jnp.asarray(bits), xx, 0,
                                                       norm, 0.0), jnp.asarray(x))
    else:
        mask = tnorm.dropedge_mask(seed, adj.shape[0], n, p).numpy()
        assert 0 < mask.sum() < mask.size
        a_n = _jax_dense(norm, adj, mask, p)
        want, vjp = jax.vjp(lambda xx: jnp.einsum("bij,bjf->bif", a_n, xx),
                            jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    tx = torch.as_tensor(x).requires_grad_()
    out = tpp.packed_spmm(torch.as_tensor(bits), tx, norm, p, seed)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-5)


def test_dropedge_mask_golden_values():
    """The counter hash is part of the port's definition: the CUDA
    kernel computes the same words.  Pinned values, and the split
    int64 products against plain Python integers."""
    assert [tnorm.mix32(v) for v in (0, 1, 2, 12345, 2**31 - 2)] == [
        0, 1753845952, 3507691905, 2435775735, 2873130988]

    def mix_ref(v):
        v ^= v >> 16
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x846CA68B) & 0xFFFFFFFF
        return v ^ (v >> 16)

    words = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    got = tnorm.mix32(torch.as_tensor(words.astype(np.int64))).tolist()
    assert got == [mix_ref(int(v)) for v in words]
    # keep(seed=7, b=1, i=2, j=3) at p=0.5, by hand
    key = mix_ref((mix_ref(7) + 1) & 0xFFFFFFFF)
    h = mix_ref(key ^ (2 << 16 | 3))
    assert tnorm.dropedge_mask(7, 2, 4, 0.5)[1, 2, 3].item() == float(
        h > int(0.5 * (2**32 - 1)))
    assert tnorm.drop_threshold(0.05) == 214748364


@pytest.mark.parametrize("p", [0.05, 0.5])
def test_dropedge_mask_kept_fraction(p):
    m = tnorm.dropedge_mask(99, 8, 112, p)         # 100,352 entries
    sigma = (p * (1 - p) / m.numel()) ** 0.5
    assert abs(m.mean().item() - (1 - p)) < 4 * sigma
    assert torch.equal(tnorm.dropedge_mask(99, 8, 112, 0.0), torch.ones_like(m))


def test_dropedge_mask_varies_with_seed_and_block():
    a = tnorm.dropedge_mask(5, 3, 64, 0.3)
    b = tnorm.dropedge_mask(6, 3, 64, 0.3)
    assert not torch.equal(a, b)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    # block b of a larger batch is the same block: the mask depends on
    # (seed, b, i, j) only
    assert torch.equal(tnorm.dropedge_mask(5, 5, 64, 0.3)[:3], a)
    assert torch.equal(tnorm.dropedge_mask(5, 3, 80, 0.3)[:, :64, :64], a)


@pytest.mark.parametrize("norm", ["none", "rw", "sym", "gin"])
def test_dropedge_mask_same_in_forward_and_backward(norm):
    """The backward regenerates the forward's mask from the seed: the
    transposed product is the exact transpose of the forward's matrix."""
    adj, _ = _case(24, b=4)
    bits = tcache.pack_bits(torch.as_tensor(adj))
    eye = torch.eye(24).expand(4, 24, 24).contiguous()
    w = tpp.packed_spmm(bits, eye, norm, 0.5, 77)           # = W
    wt = tpp.packed_spmm_t(bits, eye, norm, 0.5, 77)        # = W^T
    assert torch.equal(wt, w.transpose(1, 2))
    assert not torch.equal(w, tpp.packed_spmm(bits, eye, norm, 0.5, 78))
    # autograd's backward is that transposed product under the same seed
    x = eye.clone().requires_grad_()
    tpp.packed_spmm(bits, x, norm, 0.5, 77).sum().backward()
    assert torch.equal(x.grad, tpp.packed_spmm_t(bits, torch.ones_like(eye),
                                                 norm, 0.5, 77))


def test_packed_spmm_wrapper_guards(monkeypatch):
    adj, x = _case(13)
    bits = tcache.pack_bits(torch.as_tensor(adj))
    tx = torch.as_tensor(x)
    # the bf16 mode runs on the CPU as its plain version, in both
    # directions, and counts no launch
    launches = (tpp.packed_spmm.launches_bf16, tpp.packed_spmm_t.launches_bf16)
    for fn, t in ((tpp.packed_spmm, False), (tpp.packed_spmm_t, True)):
        assert torch.equal(fn(bits, tx, "rw", 0.1, 3, bf16=True),
                           tpp.packed_spmm_plain(bits, tx, "rw", 0.1, 3, t, True))
    assert (tpp.packed_spmm.launches_bf16, tpp.packed_spmm_t.launches_bf16) == launches
    with pytest.raises(ValueError):
        tpp.packed_spmm(bits, tx, "mean")
    for p in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropedge"):
            tpp.packed_spmm(bits, tx, "rw", dropedge=p)
        with pytest.raises(ValueError, match="dropedge"):
            tpp.packed_spmm_t(bits, tx, "rw", dropedge=p)
    # a tensor that is neither on the CPU nor on CUDA never reaches the
    # plain version, in either direction
    with pytest.raises(ValueError):
        tpp.packed_spmm(bits, tx.to("meta"), "rw")
    with pytest.raises(ValueError):
        tpp.packed_spmm_t(bits, tx.to("meta"), "rw", 0.1, 3)
    # on the CPU neither direction counts a kernel launch
    launches = (tpp.packed_spmm.launches, tpp.packed_spmm_t.launches)
    xg = tx.clone().requires_grad_()
    tpp.packed_spmm(bits, xg, "rw", 0.1, 3).sum().backward()
    assert (tpp.packed_spmm.launches, tpp.packed_spmm_t.launches) == launches
    # entry points asked for CUDA on a host without it raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("b,n", [(1, 13), (8, 24), (64, 37), (256, 208),
                                 (4, 1330)])
def test_launch_dims(b, n):
    """One cluster of CTAs per (subgraph, feature split): the CTAs' tiles
    cover the N output lines once, the splits every chunk of F once, and
    shared memory holds the counts, the scales and a bitmap of the tile;
    the two directions launch alike up to the transposed kernel's N."""
    words = -(-n // 32)
    for f in (37, 256, 500):
        d = tpp.launch_dims(b, n, f)
        assert d == tpp.launch_dims(b, n, f, transpose=True)
        assert d.threads == tpp.THREADS and d.threads % 32 == 0
        # the cluster: a power of two up to 8, about TILE_ROWS lines a CTA
        assert d.cluster in (1, 2, 4, 8)
        assert d.cluster == 8 or d.cluster * tpp.TILE_ROWS >= n
        assert d.cluster == 1 or (d.cluster // 2) * tpp.TILE_ROWS < n
        assert d.tile == -(-n // d.cluster) and (d.cluster - 1) * d.tile < n
        assert d.sub == d.tile          # the whole tile in one bitmap
        # the feature splits: every chunk of 128 in exactly one
        chunks = -(-f // tpp.CHUNK)
        assert (d.fsplit - 1) * d.per < chunks <= d.fsplit * d.per
        assert d.fsplit == 1 or b * d.cluster * (d.fsplit - 1) < 2 * tpp.SMS
        assert d.grid == b * d.fsplit * d.cluster
        # counts (u32) and scales (f32) of every row, the bitmap, a mask
        # byte per byte column
        assert d.smem == 8 * n + 4 * d.sub * words + -(-n // 8) <= tpp.MAX_SMEM
        assert d.vec == (f % 4 == 0)
    if (b, n) == (256, 208):        # the serving shape
        assert tpp.launch_dims(b, n, 500) == (2048, 8, 128, 2418, 26, 26, 1, 4, True)
        # the serving batch of 8 splits the features to fill the card
        assert tpp.launch_dims(8, n, 500)[:8] == (256, 8, 128, 2418, 26, 26, 4, 1)
        assert tpp.launch_dims(8, n, 256).fsplit == 2
    if (b, n) == (64, 37):
        assert tpp.launch_dims(b, n, 37) == (128, 2, 128, 453, 19, 19, 1, 1, False)
    if n == 1330:                   # beyond the old transposed kernel's room
        assert tpp.launch_dims(b, n, 256).smem == 38863


def test_launch_limits():
    """The N at which each direction raises, and the grid's limit: the
    forward builds a tile larger than its bitmap room in sub-tiles, the
    transposed kernel needs its tile in one bitmap."""
    big = tpp.launch_dims(1, 28_175, 8)
    assert big.cluster == 8 and big.tile == 3522 and big.sub == 1
    assert big.smem <= tpp.MAX_SMEM
    d = tpp.launch_dims(1, 6500, 37)
    assert (d.tile, d.sub) == (813, 220) and d.sub < d.tile
    assert tpp.launch_dims(2, 3592, 37, transpose=True).sub == 449
    for n, t in ((28_176, False), (3593, True), (65_536, False), (70_000, True)):
        with pytest.raises(ValueError, match="limits"):
            tpp.launch_dims(1, n, 8, transpose=t)
    with pytest.raises(ValueError, match="limits"):
        tpp.launch_dims(2**28, 208, 500)          # 2^31 CTAs
    tpp.launch_dims(2**28 - 1, 208, 500)


def test_packed_spmm_odd_feature_widths():
    """F % 4 != 0 is taken (the kernels' scalar loads; the plain version
    here) and agrees with the dense product; F > 512 splits into groups."""
    adj, _ = _case(37, b=2)
    bits = tcache.pack_bits(torch.as_tensor(adj))
    for f in (1, 37, 130, 515):
        assert not tpp.launch_dims(2, 37, f).vec or f % 4 == 0
        x = torch.as_tensor(np.random.default_rng(f).normal(
            size=(2, 37, f)).astype(np.float32))
        for t in (False, True):
            fn = tpp.packed_spmm_t if t else tpp.packed_spmm
            w = tnorm.adj_norm_rw(torch.as_tensor(adj), 5, 0.3)
            want = torch.bmm(w.transpose(1, 2) if t else w, x)
            torch.testing.assert_close(fn(bits, x, "rw", 0.3, 5), want,
                                       rtol=1e-5, atol=1e-5)


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "shadow_gnn_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "shadow_gnn_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {m}" for m in names
                    if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        f"for m in {_FORBIDDEN!r}: sys.modules[m] = None\n"
        "import importlib, pkgutil, shadow_gnn_torch\n"
        "n = 0\n"
        "for m in pkgutil.walk_packages(shadow_gnn_torch.__path__, 'shadow_gnn_torch.'):\n"
        "    importlib.import_module(m.name); n += 1\n"
        "assert n >= 20, n\n"
        "print('ok', n)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr
