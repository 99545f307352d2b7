"""Sparse matrix-matrix products over the full graph.

The preprocessing (feature / label smoothening, ``train/preproc.py``)
propagates signals over the whole graph.  ``spmm_edges`` computes
``Y = A @ X`` from an edge list as a gather, a scale and an
``index_add_``.  On the CPU the rows are summed in edge order; on CUDA
``index_add_`` adds with atomics, so the sum order, and with it the last
bits of Y (and the step at which an iteration that tests a threshold on
Y stops), may differ from run to run.  The counterpart of
``shadow_gnn_tpu/ops/spmm.py``, which is XLA there, not a TPU kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def csr_to_edges(indptr: np.ndarray, indices: np.ndarray,
                 data: Optional[np.ndarray] = None):
    """Host-side CSR -> (src, dst, val) numpy edge list."""
    n = indptr.size - 1
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = indices.astype(np.int32)
    val = np.ones(dst.size, np.float32) if data is None else data.astype(np.float32)
    return src, dst, val


def spmm_edges(src: torch.Tensor, dst: torch.Tensor, val: torch.Tensor,
               x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Y[i] = sum_{e: src[e] = i} val[e] * X[dst[e]] (int64 src / dst,
    all on x's device)."""
    out = torch.zeros((num_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, src, val[:, None] * x[dst])
