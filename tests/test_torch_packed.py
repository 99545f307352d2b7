"""PyTorch port: bit packing and the packed aggregation against the JAX
package (Pallas kernel in interpret mode on the CPU), the kernel
wrapper's guards and launch arithmetic, and the port's isolation from
JAX."""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu.ops import pallas_packed as jpp
from shadow_gnn_tpu.sampling import cache as jcache
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


def test_packed_spmm_wrapper_guards(monkeypatch):
    adj, x = _case(13)
    bits = tcache.pack_bits(torch.as_tensor(adj))
    tx = torch.as_tensor(x)
    with pytest.raises(NotImplementedError):
        tpp.packed_spmm(bits, tx, "rw", dropedge=0.1)
    with pytest.raises(NotImplementedError):
        tpp.packed_spmm(bits, tx, "rw", transpose=True)
    with pytest.raises(NotImplementedError):
        tpp.packed_spmm(bits, tx, "rw", bf16=True)
    with pytest.raises(ValueError):
        tpp.packed_spmm(bits, tx, "mean")
    # a tensor that is neither on the CPU nor on CUDA never reaches the
    # plain version
    with pytest.raises(ValueError):
        tpp.packed_spmm(bits, tx.to("meta"), "rw")
    # entry points asked for CUDA on a host without it raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("b,n", [(1, 13), (8, 24), (64, 37), (256, 208),
                                 (4, 1330)])
def test_launch_dims(b, n):
    grid, threads, smem, tiles = tpp.launch_dims(b, n)
    r = tpp.ROWS_PER_BLOCK
    assert tiles * r >= n > (tiles - 1) * r
    assert grid == b * tiles and threads % 32 == 0 and threads >= r
    # dinv[n] f32 | scale[r] f32 | cnt[r] i32 | nbr[r*n] u16
    assert smem == 4 * n + 4 * r + 4 * r + 2 * r * n
    assert smem <= tpp.MAX_SMEM
    if (b, n) == (256, 208):        # the serving shape
        assert (grid, smem) == (3328, 7616)


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
