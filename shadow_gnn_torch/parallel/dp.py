"""Data-parallel training: everything replicated, the batch split.

The port of the JAX package's ``parallel/dp.py`` (``--partition dp``).
Every rank holds the graph, the PPR tables, the feature table and the
bit-packed subgraph cache (the trainer's own, on its device), takes its
``process_slice`` of each batch's columns, samples or gathers them from
the cache exactly as ``Trainer._sample_branch_batches`` does, and runs
:func:`parallel.partition.spmd_train_update`.  So with ``packed_adj``
each rank's SAGE / GCN / GIN aggregations launch the packed kernels
(``csrc/packed_spmm.cu``) on its columns.

JAX normalises the loss over the global batch through GSPMD and one
jitted (or epoch-scanned) program over a ``('dp',)`` mesh; that is the
loss of ``parallel/partition.py``, which this step reuses.  There is no
mesh here: each rank runs its columns, in a CUDA graph with its
collectives where the group is NCCL (``train/graphs.py``).  A cached
branch gathers and any other samples, so the step's key carries the
Trainer's cache signature: a cached and a sampled form never share a
graph.
"""
from __future__ import annotations

from shadow_gnn_torch.parallel.partition import make_step


def make_dp_train_step(trainer, mode: int):
    """The static step over this rank's columns of a batch
    (``parallel/partition.py:make_step``), its batches from
    ``Trainer._sample_branch_batches``."""
    trainer._ensure_tables(mode)
    trainer._ensure_caches(mode)
    return make_step(trainer, mode, True,
                     lambda roots, rows, gen: trainer._sample_branch_batches(
                         mode, roots, rows, gen), cached=True)
