"""Process-group bring-up: one process per device, on torch.distributed.

The port of the JAX package's ``parallel/multihost.py``.  JAX runs one
process per host, all in one global device mesh; the port runs one
process per device (a *rank*), each driving ``cuda:LOCAL_RANK`` (or the
CPU), joined in the default process group: NCCL on cards, gloo on the
CPU.

* :func:`initialize` — the counterpart of JAX's ``initialize``
  (``jax.distributed.initialize``): explicit arguments, else torchrun's
  variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), else JAX's three (``JAX_COORDINATOR_ADDRESS`` as
  ``host:port``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so that a
  launch script written for the JAX package works unchanged.  With
  nothing set, or a world of 1 from the environment, it does nothing and
  returns False; it is idempotent.
* :func:`process_slice` — this rank's contiguous, ceil-sized range of a
  globally ordered array, exactly as JAX's.

``global_dp_mesh``, ``process_local_batch`` and ``process_local_epoch``
have no counterpart: they assemble globally sharded JAX arrays from each
process's rows, and here each rank simply holds its own rows as ordinary
tensors.  The collectives the partitioned steps need are in
``parallel/collectives.py``.
"""
from __future__ import annotations

import atexit
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

_device: Optional[torch.device] = None


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None,
               device: str = "cuda",
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> bool:
    """Join the default process group.  Returns True when a group is
    (or already was) initialized.

    Each field: the explicit argument, else torchrun's variable
    (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), else JAX's (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``; the local rank is then the
    process id).  With none of them, or a world of 1 read from the
    environment, nothing is done and False returned; an explicit
    ``num_processes=1`` makes a one-rank group.

    ``device`` ``"cuda"`` binds the rank to ``cuda:LOCAL_RANK`` and
    ``"cpu"`` to the CPU; an explicit ``cuda:i`` is taken as given.
    ``backend`` defaults to ``nccl`` on a card and ``gloo`` on the CPU;
    NCCL cannot hold two ranks of one group on one card, so a local rank
    without a card of its own is refused.  ``timeout_s``: the group's
    timeout for its set-up and every collective (torch's default when
    None).
    """
    global _device
    if dist.is_initialized():
        return True
    explicit_world = num_processes is not None
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int("RANK")
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID")
    if coordinator_address is None and num_processes is None and process_id is None:
        return False
    if num_processes == 1 and not explicit_world:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs a coordinator address, a world size and a "
            f"rank; got address {coordinator_address!r}, world {num_processes!r}, "
            f"rank {process_id!r}")
    if local_rank is None:
        local_rank = process_id
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                               "the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs ranks on cards")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"more ranks than cards under NCCL: local rank {local_rank} would "
                f"need cuda:{dev.index}, and this host has "
                f"{torch.cuda.device_count()} card(s); NCCL cannot put two "
                "ranks of one group on one card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, _, port = coordinator_address.rpartition(":")
    kw = {"device_id": dev} if backend == "nccl" else {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=int(num_processes), rank=int(process_id), **kw)
    _device = dev
    atexit.register(shutdown)
    return True


def device() -> Optional[torch.device]:
    """The device :func:`initialize` bound this rank to (None before)."""
    return _device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def shutdown():
    """Leave the process group (a no-op outside one).  The CUDA graphs of
    the process go first (``train/graphs.py:release_all``): an NCCL
    communicator waits, on destruction, for every graph that holds its
    collectives.  :func:`initialize` registers this to run at exit."""
    global _device
    if dist.is_initialized():
        from shadow_gnn_torch.train.graphs import release_all
        release_all()
        dist.destroy_process_group()
    _device = None


def process_slice(n_rows_global: int) -> slice:
    """This rank's row range of a globally ordered array: contiguous
    ranges of ceil(n / world) rows in rank order; with one rank the
    whole array."""
    pc, pi = world_size(), rank()
    per = -(-n_rows_global // pc)
    return slice(pi * per, min((pi + 1) * per, n_rows_global))
