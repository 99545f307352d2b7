"""Local ranks for one command: spawn a process group on this host.

JAX's ``--partition`` without ``--distributed`` trains over the local
devices of one process (``jax.devices()``); the port runs one process a
device, so one command spawns its ranks here (``torch.multiprocessing``,
a free port on localhost).  The CLI's ``--partition`` and the C&S
driver's ``n_shards`` use :func:`spawn`.  A rank that raises fails the
whole run (the others are stopped and the error re-raised).
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable, Optional

import torch

from shadow_gnn_torch.parallel import multihost as mh


def local_world(device: str, requested: int) -> int:
    """The ranks of a local run: ``requested``, or with 0 every card
    (``device`` cuda); the CPU needs an explicit count."""
    if requested > 0:
        return requested
    if torch.device(device).type != "cuda":
        raise ValueError("on the CPU the number of ranks must be given "
                         "(--partition_devices N, or n_shards)")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu and a rank count")
    return torch.cuda.device_count()


def check_cards(device: str, world: int, backend: Optional[str] = None):
    """Refuse more NCCL ranks than local cards."""
    if (torch.device(device).type == "cuda" and (backend or "nccl") == "nccl"
            and world > torch.cuda.device_count()):
        raise RuntimeError(
            f"more ranks than cards under NCCL: {world} ranks, "
            f"{torch.cuda.device_count()} card(s); NCCL cannot put two ranks "
            "of one group on one card")


def _entry(rank: int, fn: Callable, world: int, device: str, port: int,
           backend: Optional[str], args: tuple, out: str, threads: int,
           timeout_s: Optional[float]):
    if threads:
        torch.set_num_threads(threads)
    mh.initialize(f"127.0.0.1:{port}", world, rank, local_rank=rank,
                  device=device, backend=backend, timeout_s=timeout_s)
    try:
        res = fn(*args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        mh.shutdown()


def spawn(fn: Callable, world: int, device: str = "cuda", args: tuple = (),
          backend: Optional[str] = None, threads: int = 0,
          timeout_s: Optional[float] = None) -> Any:
    """Run ``fn(*args)`` on ``world`` local ranks, each joined to one
    process group first (rank r on ``cuda:r`` for ``device`` cuda, or on
    ``device`` as given, e.g. ``cuda:0`` with ``backend="gloo"``); returns
    rank 0's result.  ``threads``: torch threads a rank (0: the host's
    cores shared out among CPU ranks, torch's default on cards);
    ``timeout_s``: the group's timeout (``multihost.initialize``)."""
    import torch.multiprocessing as mp
    check_cards(device, world, backend)
    if not threads and torch.device(device).type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // world)
    fd, out = tempfile.mkstemp(suffix=".pkl")
    os.close(fd)
    try:
        mp.spawn(_entry, args=(fn, world, device, mh.free_port(), backend, args, out,
                               threads, timeout_s), nprocs=world, join=True)
        with open(out, "rb") as f:
            return pickle.load(f)
    finally:
        os.unlink(out)
