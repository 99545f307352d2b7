"""Row-sharded feature tables and the SPMD training update.

The port of the JAX package's ``parallel/partition.py``.  One process a
device (``parallel/multihost.py``): each rank holds a contiguous row
range of the node-feature table, samples its own columns of every batch
and fetches the feature rows of its subgraphs through
:func:`sharded_feat_gather`, the collective lookup that lets a
papers100M-class table (57 GB) exceed one card's memory.

* :func:`sharded_feat_gather` — JAX's form: the batch node ids are
  all-gathered, every rank serves the rows it owns (zero elsewhere) and
  a sum reduce-scatter returns each rank its own rows.  Each row has
  one owner, so the sum is exact and equals JAX's output bit for bit.
  It moves world x the rows that an owner-routed ``all_to_all_single``
  would; that form needs a count exchange first and uneven splits, and
  at the widths of one host (world <= 8, a few MB a batch) the one
  shared pattern (the CSR fetches of ``parallel/edgepart.py`` are the
  same) was kept.
* :func:`spmd_weighted_loss`, :func:`spmd_train_update`,
  :func:`spmd_eval_loss` — the exact global loss: each rank divides its
  numerator by the all-reduced weight sum, the loss is the all-reduce
  of the parts, the gradients are all-reduced by sum, then clipped by
  their global norm (``CLIP_NORM``) and applied by Adam on every rank,
  so the parameters stay bit-equal across ranks.  Not
  ``DistributedDataParallel``, which averages over the world and so
  deviates whenever a tail batch's ``w = 0`` rows land unevenly.
* :func:`make_step` — the partitioned step as a function of static
  buffers (``step(buf, generator, sampler)``), the counterpart of JAX's
  jitted ``shard_map`` step: its only inputs are this rank's roots,
  table rows, labels, weights and dropedge seed in ``buf``; the dropout
  masks come from ``generator`` and the samplers' draws from
  ``sampler``.  A Trainer whose group is NCCL captures it in a CUDA
  graph with its collectives (``train/graphs.py``); gloo, the CPU and
  the eager twin call it directly.
* :func:`make_sharded_train_step` (``--partition feat``) — graph and
  PPR tables replicated, sampling local, the feature table row-sharded
  (a bf16 table shards as bf16); a train and an evaluation form.  Like
  JAX it samples every batch and never reads the packed cache.
* :func:`make_sharded_gather_fn` — a sharded table and its gather.

JAX's ``lax.scan`` epoch programs and ``put_global`` have no
counterpart: each rank holds its rows as ordinary tensors and runs one
step a batch.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from shadow_gnn_torch.nn.model import predict_fn
from shadow_gnn_torch.parallel import collectives as cc
from shadow_gnn_torch.parallel import multihost as mh
from shadow_gnn_torch.sampling.batch import total_overflow


def pad_rows_to_shards(tab: np.ndarray, n_shards: int) -> np.ndarray:
    rows = tab.shape[0]
    pad = (-rows) % n_shards
    if pad:
        tab = np.concatenate(
            [tab, np.zeros((pad,) + tab.shape[1:], tab.dtype)], 0)
    return tab


def local_rows(tab: np.ndarray, n_shards: int, shard: int) -> np.ndarray:
    """Shard ``shard`` of ``pad_rows_to_shards(tab, n_shards)`` without
    building the padded table."""
    nl = -(-tab.shape[0] // n_shards)
    part = tab[shard * nl:(shard + 1) * nl]
    if part.shape[0] < nl:
        part = np.concatenate(
            [part, np.zeros((nl - part.shape[0],) + tab.shape[1:], tab.dtype)], 0)
    return part


def shard_table(tab: np.ndarray, device, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """This rank's row shard of the host table ``tab`` on ``device``."""
    t = torch.as_tensor(np.ascontiguousarray(
        local_rows(tab, mh.world_size(), mh.rank())))
    return t.to(device=device, dtype=dtype or t.dtype)


def sharded_feat_gather(feat_local: torch.Tensor, nodes: torch.Tensor,
                        async_op: bool = False):
    """Rows of a row-sharded table for this rank's batch node ids.

    feat_local [N_local, ...] — this rank's row range
    nodes      [...] int — global ids (out-of-range ids, e.g. the
               num_nodes sentinel, give zero rows)
    Returns    [*nodes.shape, ...] in ``feat_local``'s dtype (with
               ``async_op`` a handle whose ``wait()`` gives it).
    """
    n_local = feat_local.shape[0]
    nodes_all = cc.all_gather(nodes)                       # [W, *nodes]
    local = nodes_all - mh.rank() * n_local
    ok = (local >= 0) & (local < n_local)
    vals = feat_local[torch.clamp(local, 0, n_local - 1)]
    ok = ok.reshape(ok.shape + (1,) * (vals.dim() - ok.dim()))
    vals = vals * ok.to(vals.dtype)
    return cc.reduce_scatter_sum(vals, async_op=async_op)


def spmd_weighted_loss(cfg, logits, labels, w) -> torch.Tensor:
    """This rank's part of the globally normalised weighted loss: its
    numerator over the all-reduced weight sum; the all-reduce of the
    parts is the single-card loss, and so are its gradients."""
    from shadow_gnn_torch.train.pipeline import weighted_loss_parts
    num, den = weighted_loss_parts(cfg, logits, labels, w)
    den_g = cc.all_reduce_sum(den.detach())
    return num / torch.clamp(den_g, min=1.0)


def all_reduce_grads(params: List[torch.nn.Parameter]):
    """Sum every gradient over the ranks, in one flat all-reduce."""
    ps = [p for p in params if p.grad is not None]
    if not ps:
        return
    flat = cc.all_reduce_sum(torch.cat([p.grad.reshape(-1) for p in ps]))
    off = 0
    for p in ps:
        n = p.grad.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n


def _overflow(batches, device) -> torch.Tensor:
    """The batches' overflow summed on the device, then over the ranks: a
    0-d int64 tensor, read once at the epoch's end."""
    return cc.all_reduce_sum(total_overflow(batches, device))


def spmd_train_update(trainer, batches, feats, labels, w, generator, seed):
    """One SPMD update shared by every partition step: forward and
    backward on this rank's rows (dropout from ``generator``, dropedge
    from ``seed``, an int or a 0-d int64 device tensor), global loss
    normalisation, summed gradients, the global-norm clip, Adam.
    Returns (global loss, this rank's logits, the summed induction
    overflow, the gradients)."""
    from shadow_gnn_torch.train.pipeline import CLIP_NORM, clip_grad_global_norm_
    model, cfg = trainer.model, trainer.model_cfg
    trainer.optimizer.zero_grad(set_to_none=True)
    logits, _ = model(batches, feats, generator, seed, True)
    part = spmd_weighted_loss(cfg, logits, labels, w)
    part.backward()
    all_reduce_grads(list(model.parameters()))
    clip_grad_global_norm_(model.parameters(), CLIP_NORM)
    trainer.optimizer.step()
    loss = cc.all_reduce_sum(part.detach())
    return (loss, logits.detach(), _overflow(batches, labels.device),
            [p.grad for p in model.parameters()])


@torch.no_grad()
def spmd_eval_loss(trainer, batches, feats, labels, w, mode_train: bool):
    """Evaluation counterpart of :func:`spmd_train_update`: the global
    loss, this rank's logits and the summed overflow."""
    logits, _ = trainer.model(batches, feats, mode_train=mode_train)
    loss = cc.all_reduce_sum(spmd_weighted_loss(trainer.model_cfg, logits, labels, w))
    return loss, logits, _overflow(batches, labels.device)


def make_step(trainer, mode: int, train: bool, sample_all: Callable,
              deps: tuple = (), cached: bool = False):
    """The partitioned step of ``mode`` over this rank's columns, a
    function of static buffers: ``step(buf, generator, sampler) -> (global
    loss, predictions of the global batch in rank order, the summed
    overflow[, the gradients])``, ``buf`` holding ``roots`` / ``rows``
    [b, T], ``labels``, ``w`` and, to train, ``seed``.  The batches come
    from ``sample_all(roots, rows, sampler) -> (batches, feats)``.  The
    step keeps ``sample_all``, ``deps`` (the tensors of the partition
    that it reads besides the Trainer's: a table shard, a CSR shard) and
    ``sig()``, the branches' forms in its key: the Trainer's cache
    signature where ``cached`` (``sample_all`` gathers a cached branch),
    else every branch "sampled"."""
    from shadow_gnn_torch import TRAIN

    def step(buf, generator, sampler):
        with torch.no_grad():
            batches, feats = sample_all(buf["roots"], buf["rows"], sampler)
        if train:
            loss, logits, ovf, grads = spmd_train_update(
                trainer, batches, feats, buf["labels"], buf["w"], generator,
                buf["seed"])
        else:
            loss, logits, ovf = spmd_eval_loss(trainer, batches, feats, buf["labels"],
                                               buf["w"], mode == TRAIN)
        preds = cc.all_gather_rows(predict_fn(trainer.model_cfg, logits))
        # the gradients stay with the graph: a replay writes them
        return (loss, preds, ovf, grads) if train else (loss, preds, ovf)

    step.sample_all = sample_all
    step.deps = tuple(deps)
    step.sig = ((lambda: trainer._cache_sig(mode)) if cached else
                (lambda: ("sampled",) * trainer.num_ensemble))
    return step


def make_sharded_train_step(trainer, mode: int, train: bool = True):
    """``--partition feat``: graph and PPR tables replicated (the
    trainer's), sampling local, the feature table row-sharded in the
    trainer's ``feat_dtype``.  Returns (step, this rank's table shard);
    ``step`` as :func:`make_step` (``train=False``: the evaluation
    form)."""
    from shadow_gnn_torch.sampling.samplers import sample_subgraphs
    trainer._ensure_tables(mode)
    dt = torch.bfloat16 if trainer.feat_dtype == "bfloat16" else torch.float32
    feat_local = shard_table(trainer.feat_np, trainer.device, dt)
    graph, tables = trainer.graph[mode], trainer.tables[mode]
    n_id, dtype = trainer.num_nodes, trainer.model_cfg.dtype

    def sample_all(roots, rows, gen):
        batches, feats = [], []
        for i, br in enumerate(trainer.branches):
            batch = sample_subgraphs(br["cfg"][mode], graph, roots, rows, tables[i],
                                     gen)
            # the model masks the feature block itself (nn/model.py)
            feats.append(sharded_feat_gather(
                feat_local, torch.clamp(batch.nodes, max=n_id - 1)).to(dtype))
            batches.append(batch)
        return batches, feats

    return (make_step(trainer, mode, train, sample_all, (feat_local,)),
            feat_local)


def make_sharded_gather_fn(feat_tab: np.ndarray, device="cuda"):
    """This rank's shard of the host table ``feat_tab`` and
    ``gather(nodes [...]) -> [..., F]`` over it (JAX's
    ``make_sharded_gather_fn`` with the mesh's rank)."""
    feat_local = shard_table(np.asarray(feat_tab), device)
    return feat_local, lambda nodes: sharded_feat_gather(feat_local, nodes)
