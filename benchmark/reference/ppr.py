"""PPR top-k tables by the lazy walk's power iteration.

    pi <- a * e_t + (1 - a) / 2 * (pi + P^T pi),   pi_0 = a * e_t,

with ``a = 1 - alpha`` (``alpha`` the configuration's 0.85), ``P =
D^-1 A`` (degrees at least 1), a fixed number of iterations in f32, and
each target's ``k`` largest positive scores.  ``P^T pi`` is a CSR
product whose rows list their sources in ascending order, one
reduction a row, so that two runs give equal scores and equal ties.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

NUM_ITER = 50
BLOCK = 512


def transition_t(indptr: np.ndarray, indices: np.ndarray, device) -> torch.Tensor:
    """P^T as a sparse CSR matrix on ``device``."""
    n = indptr.size - 1
    indptr_t = torch.as_tensor(np.asarray(indptr, np.int64), device=device)
    dst = torch.as_tensor(np.asarray(indices, np.int64), device=device)
    deg = indptr_t[1:] - indptr_t[:-1]
    src = torch.repeat_interleave(torch.arange(n, device=device), deg)
    inv = 1.0 / torch.clamp(deg, min=1).to(torch.float32)
    order = torch.argsort(dst * n + src)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(torch.bincount(dst, minlength=n), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(crow, src[order], inv[src[order]], size=(n, n))


def topk_tables(p_t: torch.Tensor, targets: np.ndarray, k: int, alpha: float,
                num_iter: int = NUM_ITER, block: int = BLOCK):
    """(neighs [T, k] int64, pad -1; scores [T, k] f32, pad 0) of
    ``targets`` on the graph of ``p_t``, ``block`` targets a pass."""
    dev = p_t.device
    n = p_t.shape[0]
    a = 1.0 - alpha
    c = (1.0 - a) * 0.5
    cols = torch.arange(block, device=dev)
    out_n, out_s = [], []
    for s in range(0, len(targets), block):
        blk = np.asarray(targets[s:s + block], np.int64)
        at = torch.as_tensor(np.pad(blk, (0, block - blk.size)), device=dev)
        pi = torch.zeros(n, block, device=dev)
        pi[at, cols] = a
        for _ in range(num_iter):
            pi = torch.add(pi, torch.sparse.mm(p_t, pi)).mul_(c)
            pi[at, cols] += a
        val, idx = torch.topk(pi.T[:blk.size], min(k, n))
        keep = val > 0
        out_n.append(torch.where(keep, idx, -1))
        out_s.append(torch.where(keep, val, 0.0))
    neighs, scores = torch.cat(out_n), torch.cat(out_s)
    if neighs.shape[1] < k:
        pad = k - neighs.shape[1]
        neighs = torch.nn.functional.pad(neighs, (0, pad), value=-1)
        scores = torch.nn.functional.pad(scores, (0, pad))
    return neighs, scores
