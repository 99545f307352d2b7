"""The collectives of the partitioned steps, in one place.

Each wraps one torch.distributed call over the default process group
(``parallel/multihost.py``) and takes the place of one JAX collective
inside ``shard_map``:

====================  =====================================  ===============
here                  torch.distributed                      JAX
====================  =====================================  ===============
:func:`all_gather`    ``all_gather_into_tensor``             ``lax.all_gather``
:func:`reduce_scatter_sum` ``reduce_scatter_tensor``         ``lax.psum_scatter``
:func:`all_reduce_sum` ``all_reduce``                        ``lax.psum``
:func:`ring_shift`    ``batch_isend_irecv``                  ``lax.ppermute``
====================  =====================================  ===============

These names exist in every torch from 2.1 on; torch 2.13 warns that
two of them are deprecated, and the warning is silenced here.

The gloo backend does not promise collectives on CUDA tensors.  Where
the group's backend is gloo and a tensor lies on a card, each call
copies it to host memory, runs the collective there and copies the
result back: that is gloo's own rule, not a fallback, and an NCCL group
passes CUDA tensors straight through.  Bool tensors travel as uint8.

``stats`` counts the calls, their bytes and, while ``timing`` is on,
their seconds and those of the gloo staging.  Timing synchronises the
card before and after each call (otherwise a call's host time is its
enqueue only), so it is off unless a measurement asks for it.

An NCCL group's calls are captured in the CUDA graphs of the
partitioned steps (``train/graphs.py``): the collective runs on NCCL's
stream, joined to the capturing stream before and after, and an
asynchronous call's ``wait`` is that join, not a host wait.  A replay
runs no Python, so the graphs take a capture's calls and bytes and
credit them on each replay (``graphs.launch_counters``).  ``timing``
cannot be captured (:func:`refuse_timing`), and gloo's staging through
host memory neither: a gloo group's steps run eagerly.  The ring shift
is captured as the others are: its send and receive run on NCCL's
stream, its receive buffer is allocated inside the capture (from the
graph's pool) and its ``wait`` is a join.  c10d creates the
communicator of a send / receive pair on its first ``batch_isend_irecv``,
so a key's eager warm-up must run the shifts before its capture.

Outside a process group (a world of 1, the JAX package's one-device
mesh) each collective answers locally, as JAX's does on one device: the
gather stacks the one tensor, the sums return it, the ring shift sends
it to itself.  Nothing is counted then, since nothing travels.
"""
from __future__ import annotations

import time
import warnings
from typing import List

import torch
import torch.distributed as dist

from shadow_gnn_torch.parallel import multihost as mh

timing = False
stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "stage_seconds": 0.0}


def reset_stats():
    stats.update(calls=0, bytes=0, seconds=0.0, stage_seconds=0.0)


def refuse_timing(what: str):
    """Raise while ``timing`` is on: its synchronisations cannot be held
    by the CUDA graph of ``what``."""
    if timing:
        raise RuntimeError(
            f"collectives.timing synchronises the card around each call, which "
            f"the CUDA graph of {what} cannot hold: time the collectives on an "
            "eager Trainer (cuda_graphs=False), or read NCCL's share of the "
            "device time from torch.profiler")


def _local() -> bool:
    """Whether this process is in no group: a world of 1 answered here."""
    return not dist.is_initialized()


def _sync(t: torch.Tensor):
    if timing and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and mh.backend() == "gloo"


class _Call:
    """Time one collective (when ``timing``) and count it."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __enter__(self):
        stats["calls"] += 1
        stats["bytes"] += self.t.numel() * self.t.element_size()
        _sync(self.t)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.t)
        if timing:
            stats["seconds"] += time.perf_counter() - self.t0


def _to_wire(t: torch.Tensor):
    """(tensor as the backend takes it, dtype to restore)."""
    dt = t.dtype
    if dt == torch.bool:
        t = t.to(torch.uint8)
    if _staged(t):
        t0 = time.perf_counter()
        t = t.cpu()
        if timing:
            stats["stage_seconds"] += time.perf_counter() - t0
    return t.contiguous(), dt


def _from_wire(t: torch.Tensor, like: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    if t.device != like.device:
        t0 = time.perf_counter()
        t = t.to(like.device)
        if timing:
            _sync(t)
            stats["stage_seconds"] += time.perf_counter() - t0
    return t.to(dt) if t.dtype != dt else t


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """[world, *t.shape]: every rank's ``t`` in rank order (JAX
    ``lax.all_gather(t, axis)``)."""
    if _local():
        return t.unsqueeze(0).clone()
    w = mh.world_size()
    with _Call(t):
        x, dt = _to_wire(t)
        out = torch.empty(w * x.numel(), dtype=x.dtype, device=x.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, x.reshape(-1))
        return _from_wire(out.view((w,) + tuple(x.shape)), t, dt)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` concatenated in rank order (JAX's
    ``all_gather(..., axis=0, tiled=True)``); equal row counts."""
    g = all_gather(t)
    return g.reshape((-1,) + tuple(t.shape[1:]))


class _Pending:
    """An asynchronous reduce-scatter: :meth:`wait` gives its result."""

    def __init__(self, work, out, like, dt):
        self.work, self.out, self.like, self.dt = work, out, like, dt

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return _from_wire(self.out, self.like, self.dt)


def reduce_scatter_sum(x: torch.Tensor, async_op: bool = False):
    """x [world, *shape] -> [*shape]: the sum over ranks of slot
    ``rank`` (JAX ``lax.psum_scatter(x, axis, scatter_dimension=0,
    tiled=False)``).  With ``async_op`` returns a handle whose ``wait()``
    gives the result."""
    w = mh.world_size()
    if x.shape[0] != w:
        raise ValueError(f"reduce_scatter_sum needs a leading dim of the world "
                         f"size {w}, got {tuple(x.shape)}")
    if _local():
        pending = _Pending(None, x[0].clone(), x, x.dtype)
        return pending if async_op else pending.wait()
    with _Call(x):
        xw, dt = _to_wire(x)
        if xw.dtype == torch.uint8 and dt == torch.bool:
            xw = xw.to(torch.int32)
        out = torch.empty(xw[0].numel(), dtype=xw.dtype, device=xw.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            work = dist.reduce_scatter_tensor(out, xw.reshape(-1), op=dist.ReduceOp.SUM,
                                              async_op=async_op)
        pending = _Pending(work if async_op else None, out.view(xw.shape[1:]), x, dt)
        return pending if async_op else pending.wait()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over ranks, on every rank (JAX ``lax.psum``);
    returns a new tensor, ``t`` is left as it was."""
    if _local():
        return t.clone()
    with _Call(t):
        x, dt = _to_wire(t)
        x = x.clone() if x.data_ptr() == t.data_ptr() else x
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return _from_wire(x, t, dt)


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (a picklable host value)."""
    if mh.world_size() == 1:
        return obj
    box: List = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def ring_shift(t: torch.Tensor) -> "_Ring":
    """Start sending ``t`` to rank - 1 and receiving rank + 1's
    (mod world) into a new buffer (JAX ``lax.ppermute`` with
    ``perm = [(j, j - 1)]``); ``wait()`` on the result gives the
    received tensor."""
    if _local():
        return _Ring([], t, t.clone(), t, t.dtype)
    w, r = mh.world_size(), mh.rank()
    stats["calls"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    x, dt = _to_wire(t)
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (r - 1) % w),
           dist.P2POp(dist.irecv, buf, (r + 1) % w)]
    return _Ring(dist.batch_isend_irecv(ops), x, buf, t, dt)


class _Ring:
    """A ring shift in flight: :meth:`wait` joins it (on NCCL a stream
    join, which a CUDA graph holds) and gives the received tensor."""

    def __init__(self, works, sent, buf, like, dt):
        self.works, self.sent, self.buf, self.like, self.dt = works, sent, buf, like, dt

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        for wk in self.works:
            wk.wait()
        _sync(self.buf)
        if timing:
            stats["seconds"] += time.perf_counter() - t0
        return _from_wire(self.buf, self.like, self.dt)


def barrier():
    if mh.world_size() > 1:
        dist.barrier()
