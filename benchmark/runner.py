"""The runner: it builds the program for a cell, hands it to the
driver of the cell's traffic entry (``entries/<entry>.py``, named by the
traffic file's ``entry``) for the warm-up, runs the measured window of
the driver's units and, in a traced run, a traced slice after it.  A
traffic file's ``world`` > 1 runs as many ranks, one a card, each
building the same Trainer with the file's ``partition``
(``parallel/launch.py`` spawns them); rank 0 keeps the clock and tells
the others when the window closes.

An entry module holds ``Driver(tr, cell, weights, split)`` (the
warm-up; ``unit(e)`` -> (roots, steps) of one window unit; ``collect()``
-> what the reference judges), ``end_to_end(out)`` -> {metric: value},
``judge(ref, out)`` -> (numbers, diagnostics, the reference's readings),
``control(ref, out, fault, want)`` -> numbers, ``FORWARDS_PER_ROOT``,
and either ``STATS_MODE`` (the mode whose node roots' subgraphs give a
traced run's mean subgraph, the FLOP and byte counts' sizes) or
``stats(ref, seed)`` -> {"nodes", "edges"}, that mean worked out by the
entry itself (a link subgraph has two roots); it names in its
docstring the program members it uses.

The program is ``shadow_gnn_torch``, imported here and by the entries
only; the runner reads its launch counters.
"""
from __future__ import annotations

import gc
import importlib.util
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from benchmark import gen, trace

TRACE_MIN_S = 3.0       # the traced slice: whole epochs until this long
_ENTRIES: Dict[str, Any] = {}   # entry modules by path


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reference_model(cfg: Dict):
    """The plain model of the configuration (``reference/<name>.py``)."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def build_trainer(cell: Dict, data: Dict, seed: int, device, partition: str = "none",
                  world: int = 0, data_dir: str = ""):
    from shadow_gnn_torch.data.graph import RawGraph
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer
    cfg = cell["config"]
    raw = RawGraph(indptr_full=data["indptr"], indices_full=data["indices"],
                   indptr_train=data["indptr_train"], indices_train=data["indices_train"],
                   feat_full=data["feat"], label_full=data["label"],
                   node_set=None if data["node_set"] is None else dict(data["node_set"]),
                   edge_set=data["edge_set"])
    opts = cfg["trainer"]
    return Trainer(cfg["dataset"], data_dir, raw, parse_config(cfg["train_config"]),
                   seed=seed, device=device, partition=partition,
                   partition_devices=world if partition != "none" else 0,
                   packed_adj=opts.get("packed_adj", False),
                   use_device_ppr=opts.get("use_device_ppr", True),
                   matmul_precision=opts.get("matmul_precision", "float32"))


def _counters():
    from shadow_gnn_torch.train.graphs import counter_values, launch_counters
    cs = launch_counters()
    names = []
    for h, n in cs:
        owner = getattr(h, "__name__", None) or (
            "collectives" if "bytes" in h else "by_norm")
        names.append(f"{owner}.{n}")
    return names, counter_values(cs)


def counter_delta(before, after) -> Dict[str, float]:
    names, b = before
    _, a = after
    out: Dict[str, float] = {}
    for k, x, y in zip(names, b, a):
        out[k] = out.get(k, 0) + (y - x)
    return out


def _stop(decide: Callable[[], bool], world: int, device) -> bool:
    """Rank 0's decision, shared with every rank."""
    if world <= 1:
        return decide()
    import torch.distributed as dist
    flag = torch.tensor([1 if decide() else 0], device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def entry_module(cell: Dict):
    """The driver of the cell's traffic entry, ``entries/<entry>.py``
    beside the cell's traffic file, found by the ``entry`` that the
    traffic file names."""
    name = cell["traffic"]["entry"]
    path = os.path.join(cell["entries_dir"], name + ".py")
    if path not in _ENTRIES:
        spec = importlib.util.spec_from_file_location(f"benchmark_entry_{name}", path)
        _ENTRIES[path] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_ENTRIES[path])
    return _ENTRIES[path]


def drive(cell: Dict, seed: int, seconds: float, traced: bool, device,
          t_start: float, rank: int = 0, world: int = 1,
          patch: Optional[Callable] = None) -> Dict[str, Any]:
    """One run of ``cell`` on ``device`` (this rank's card): the
    program's set-up and the entry's warm-up, the window of the entry's
    units, the traced slice; returns what the harness reports and what
    the reference judges (the entry's ``collect``)."""
    if patch is not None:
        patch()
    traffic, cfg = cell["traffic"], cell["config"]
    entry = entry_module(cell)
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    split = _Split(device, t_start)
    split("imports")
    data = gen.make_dataset(cfg["data"], seed, device)
    split("data")
    partition = traffic.get("partition", "none")
    data_dir = ""
    if world > 1:
        # rank 0 computes the PPR tables and writes them here; the other
        # ranks read them (the program's partitioned set-up)
        import torch.distributed as dist
        box = [tempfile.mkdtemp(prefix="ppr_") if rank == 0 else None]
        dist.broadcast_object_list(box, 0)
        data_dir = box[0]
    try:
        tr = build_trainer(cell, data, seed, device, partition, world, data_dir)
        weights = gen.make_weights(reference_model(cfg).param_specs(cfg), seed, device)
        tr.model.load_state_dict(weights, strict=True)
        del data
        split("trainer")
        drv = entry.Driver(tr, cell, weights, split)
        split("first epoch")
        t0 = time.time()
        setup_s = t0 - t_start
        roots = steps = units = 0
        unit_s = []
        while True:
            r, s = drv.unit(units + 1)
            roots, steps, units = roots + r, steps + s, units + 1
            unit_s.append(time.time() - t0 - sum(unit_s))
            if _stop(lambda: time.time() - t0 >= seconds, world, device):
                break
        _sync(device)
        window_s = time.time() - t0
        out: Dict[str, Any] = {
            "setup_s": setup_s, "setup_split": split.parts, "unit_s": unit_s,
            "window_s": window_s, "roots": roots, "steps": steps, "units": units,
            "graphs": tr.step_graphs.summary()}
        if traced:
            tracer = trace.Tracer(is_cuda)
            before = _counters()
            t_roots = t_steps = 0
            with tracer.window():
                t1 = time.time()
                while True:
                    r, s = drv.unit(units + 1)
                    units, t_roots, t_steps = units + 1, t_roots + r, t_steps + s
                    if _stop(lambda: time.time() - t1 >= min(TRACE_MIN_S, seconds),
                             world, device):
                        break
            out["counters"] = counter_delta(before, _counters())
            out["traced"] = {"roots": t_roots, "steps": t_steps}
            out["trace"] = tracer.summary()
        out["program"] = drv.collect()
        out["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                    if is_cuda else 0)
        out["preproc"] = dict(tr.preproc_log)
        out["batch_size"] = tr.batch_size
        out["per_rank"] = tr.batch_size // max(world, 1)
        del tr, weights, drv
        gc.collect()
        if is_cuda:
            torch.cuda.empty_cache()
        return out
    finally:
        if rank == 0 and data_dir:
            shutil.rmtree(data_dir, ignore_errors=True)


class _Split:
    """Seconds of each part of the set-up, each part ended by a sync."""

    def __init__(self, device, t_start: float):
        self.device, self.t, self.parts = device, t_start, {}

    def __call__(self, name: str):
        _sync(self.device)
        now = time.time()
        self.parts[name] = now - self.t
        self.t = now


def rank_main(cell: Dict, seed: int, seconds: float, traced: bool, t_start: float,
              device: str, patch: Optional[Callable]):
    """A spawned rank (``parallel/launch.py:spawn``): its card is the
    process group's device."""
    from shadow_gnn_torch.parallel import multihost as mh
    from benchmark import hygiene
    out = drive(cell, seed, seconds, traced, mh.device(), t_start, mh.rank(),
                mh.world_size(), patch)
    out["forbidden"] = hygiene.loaded_forbidden()
    import torch.distributed as dist
    peaks = [None] * mh.world_size()
    dist.all_gather_object(peaks, out["memory_peak_bytes"])
    out["memory_peak_bytes"] = max(peaks)
    if "trace" in out:
        # the device's busy seconds and the slice, averaged over the cards
        spans = [None] * mh.world_size()
        dist.all_gather_object(spans, (out["trace"]["busy_s"], out["trace"]["window_s"]))
        out["trace"]["mean_busy_s"] = sum(b for b, _ in spans) / len(spans)
        out["trace"]["mean_window_s"] = sum(w for _, w in spans) / len(spans)
    return out if mh.rank() == 0 else None


def drive_world(cell: Dict, seed: int, seconds: float, traced: bool, t_start: float,
                device: str, patch: Optional[Callable] = None) -> Dict[str, Any]:
    """``world`` ranks, one a card (gloo ranks on the CPU)."""
    from shadow_gnn_torch.parallel.launch import spawn
    world = int(cell["traffic"]["world"])
    cpu = torch.device(device).type == "cpu"
    return spawn(rank_main, world, device,
                 (cell, seed, seconds, traced, t_start, device, patch),
                 backend="gloo" if cpu else None, threads=1 if cpu else 0,
                 timeout_s=600)
