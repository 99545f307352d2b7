"""Dense adjacency normalisation and dropedge over [B, N, N] blocks.

Used by the uncached (dense) aggregation path and by the plain version
of the packed aggregation kernel.  Degrees are clipped at 1.  As in the
JAX package, the adjacency is normalised and edge-dropped once per
batch and the result is reused by every conv layer.

Dropedge mask
-------------
The TPU kernel draws its mask from the TPU's own generator, seeded
``seed + b``; those bits cannot be reproduced here.  The port defines
its own counter-based mask instead, the same on every path (the CUDA
kernel ``csrc/packed_spmm.cu``, :func:`dropedge_mask` below, and so the
packed and dense aggregations)::

    mix32(x):  x ^= x >> 16; x *= 0x7FEB352D; x ^= x >> 15;
               x *= 0x846CA68B; x ^= x >> 16          (all mod 2**32)
    key(seed, b)       = mix32((mix32(seed) + b) mod 2**32)
    keep(seed, b, i, j) = mix32(key(seed, b) XOR (i << 16 | j)) > thresh(p)
    thresh(p)          = uint32(int(p * (2**32 - 1)))   (the TPU kernel's)

``mix32`` is the "lowbias32" integer finaliser (a bijection of 32-bit
words).  ``i, j < 2**16`` (the kernel's limit on N), so every entry of
a block gets its own word.  The mask depends on (seed, b, i, j) only:
the three layers of one step and their three backward products see the
same mask without storing it.  Entries are kept with probability
1 - p up to 2**-32.  On int64 tensors each 32x32-bit product is split
into two 32x16-bit ones, so nothing exceeds 2**49 and the result is the
CUDA kernel's bit for bit.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
MIX_MUL1 = 0x7FEB352D
MIX_MUL2 = 0x846CA68B


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32) (int or int64 tensor)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(x):
    """The lowbias32 finaliser on 32-bit words (int or int64 tensor)."""
    x = x ^ (x >> 16)
    x = _mul32(x, MIX_MUL1)
    x = x ^ (x >> 15)
    x = _mul32(x, MIX_MUL2)
    return x ^ (x >> 16)


def drop_threshold(p: float) -> int:
    """uint32 threshold: an entry is kept when its hash exceeds it."""
    return int(p * (2**32 - 1))


def dropedge_mask(seed: int, b: int, n: int, p: float,
                  device=None) -> torch.Tensor:
    """[b, n, n] float keep-mask of blocks 0..b-1 under ``seed``; all
    ones when p == 0 (see the module docstring for the hash)."""
    if p <= 0.0:
        return torch.ones((b, n, n), device=device)
    key = mix32((mix32(int(seed) & _M32)
                 + torch.arange(b, dtype=torch.int64, device=device)) & _M32)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    ij = (idx[:, None] << 16) | idx[None, :]
    h = mix32(key[:, None, None] ^ ij[None])
    return (h > drop_threshold(p)).float()


def adj_norm_sym(adj: torch.Tensor, seed: int = 0,
                 dropedge: float = 0.0) -> torch.Tensor:
    """Symmetric D^-1/2 A_drop D^-1/2.  An edge survives dropedge only
    if both of its directions survive (s * s^T with s = A * keep)."""
    if dropedge > 0.0:
        s = adj * dropedge_mask(seed, adj.shape[0], adj.shape[-1], dropedge,
                                adj.device)
        adj = s * s.transpose(-1, -2)
    d_inv_sqrt = torch.rsqrt(torch.clamp(adj.sum(-1), min=1.0))
    return adj * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]


def adj_norm_rw(adj: torch.Tensor, seed: int = 0,
                dropedge: float = 0.0) -> torch.Tensor:
    """Random-walk D_drop^-1 A_drop: every surviving edge of row i gets
    1/deg_dropped(i)."""
    if dropedge > 0.0:
        adj = adj * dropedge_mask(seed, adj.shape[0], adj.shape[-1], dropedge,
                                  adj.device)
    return adj / torch.clamp(adj.sum(-1), min=1.0)[..., :, None]


def adj_gin_rescale(adj: torch.Tensor, seed: int = 0,
                    dropedge: float = 0.0) -> torch.Tensor:
    """GIN dropedge: surviving edges of row i get deg(i)/deg_dropped(i);
    no normalisation."""
    if dropedge <= 0.0:
        return adj
    deg = adj.sum(-1)
    adj_d = adj * dropedge_mask(seed, adj.shape[0], adj.shape[-1], dropedge,
                                adj.device)
    return adj_d * (deg / torch.clamp(adj_d.sum(-1), min=1.0))[..., :, None]


def adj_drop(adj: torch.Tensor, seed: int = 0,
             dropedge: float = 0.0) -> torch.Tensor:
    """The raw 0/1 adjacency with dropped edges zeroed (norm "none")."""
    if dropedge <= 0.0:
        return adj
    return adj * dropedge_mask(seed, adj.shape[0], adj.shape[-1], dropedge,
                               adj.device)


def prepare_adj(aggr: str, adj: torch.Tensor, seed: int = 0,
                dropedge: float = 0.0) -> torch.Tensor:
    """Once-per-batch normalised, edge-dropped adjacency of a conv stack
    (the sage / gcn / gin branches of the JAX package's prepare_adj)."""
    if aggr == "gcn":
        return adj_norm_sym(adj, seed, dropedge)
    if aggr == "sage":
        return adj_norm_rw(adj, seed, dropedge)
    if aggr == "gin":
        return adj_gin_rescale(adj, seed, dropedge)
    raise NotImplementedError(f"prepare_adj for aggr {aggr!r} is not ported yet")
