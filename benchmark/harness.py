"""The harness: a cell found by name, run once, and its result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the ``file`` of its entry): the sizes and
  the task (its ``data`` block, which ``gen.py`` reads), the training
  configuration and the name of its plain reference,
  ``reference/<reference>.py``;
* ``traffic/<traffic>.json``: the mix's parameters, among them its
  ``entry``, the driver that runs it: ``entries/<entry>.py``, which
  drives the program's entry, works out the end-to-end metrics and
  judges the answers against the reference (``runner.py`` says what it
  holds);
* ``workloads/<cell>.json``: the cell's check and the limit of each
  compared number;
* ``metrics/<metric>.py``, else ``metrics/<stem>.py`` for the part of
  the name before the first dot: the reader of a per-layer metric,
  ``read(ctx) -> float | None``.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import os
from typing import Any, Callable, Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _merge(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, root: str = ROOT, overrides: Optional[Dict] = None) -> Dict:
    """The cell ``name`` of ``root``'s BENCHMARK.json: its workload entry,
    configuration, traffic, check and metrics.  ``overrides`` ({"config":
    ..., "traffic": ..., "check": ...}) are merged in (the tests' small
    sizes)."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    centry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    bench = os.path.join(root, spec["paths"][0])
    cell = {
        "name": name, "chips": wl["chips"], "workload": wl,
        "config": _json(os.path.join(root, centry["file"])),
        "traffic": _json(os.path.join(bench, "traffic", wl["traffic"] + ".json")),
        "check": _json(os.path.join(bench, "workloads", name + ".json")),
        "metrics_dir": os.path.join(bench, "metrics"),
        "entries_dir": os.path.join(bench, "entries"),
    }
    for k, v in (overrides or {}).items():
        cell[k] = _merge(cell[k], v)
    cell["end_to_end"] = [m for m in spec["end_to_end"]
                          if name in m.get("workloads", [name])]
    reported = {m["name"] for m in cell["end_to_end"]}
    cell["per_layer"] = [m for m in spec["per_layer"]
                         if name in m.get("workloads", [name] if m["moves"] in reported
                                          else [])]
    return cell


def reader(metrics_dir: str, name: str) -> Callable[[Dict], Optional[float]]:
    """The reader of the per-layer metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(metrics_dir, stem + ".py")
        if os.path.isfile(path):
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for the per-layer metric {name!r}")


def check_numbers(cell: Dict, readings: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit (the cell file's
    ``limits``)."""
    limits = cell["check"]["limits"]
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def _lookup(values: Dict[str, float], name: str) -> float:
    """``name``'s value, else that of its stem (before the first dot)."""
    return values[name] if name in values else values[name.split(".")[0]]


def assemble(cell: Dict, out: Dict, checks: Dict, traced: bool, device: Dict,
             end_to_end: Dict[str, float], metrics_extra: Optional[Dict] = None) -> Dict[str, Any]:
    """The result line: correct, attempted, failed, metrics, device,
    breakdown (traced), and the compared numbers last.  ``end_to_end``:
    the entry's values, by metric name or stem; ``setup_s`` is the
    runner's."""
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    metrics: Dict[str, Dict] = {}
    values = dict(end_to_end, setup_s=out["setup_s"])
    if not traced:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": _lookup(values, m["name"]), "unit": m["unit"]}
    elif out.get("trace", {}).get("busy_s", 0) > 0:
        # per-layer numbers come from a traced slice in which the device ran
        ctx = dict(out, cell=cell, config=cell["config"], chips=cell["chips"],
                   rate=out["roots"] / out["window_s"], end_to_end=values,
                   **(metrics_extra or {}))
        for m in cell["per_layer"]:
            value = reader(cell["metrics_dir"], m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    res = {"correct": failed == 0, "attempted": int(out["roots"]), "failed": failed,
           "metrics": metrics, "device": device}
    if traced and "trace" in out:
        t = out["trace"]
        res["device"] = dict(device, busy_s=t.get("mean_busy_s", t["busy_s"]),
                             window_s=t.get("mean_window_s", t["window_s"]))
        res["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    res["checks"] = checks
    return res


def subgraph_stats(cell: Dict, entry, ref, seed: int) -> Dict[str, float]:
    """The mean real nodes and edges of the cell's subgraphs: the
    entry's own ``stats(ref, seed)`` where it has one, else the
    reference's subgraphs of ``stats_roots`` node roots of the entry's
    ``STATS_MODE``, drawn from the seed."""
    if hasattr(entry, "stats"):
        return entry.stats(ref, seed)
    import numpy as np
    pool = ref.data["node_set"][entry.STATS_MODE]
    roots = np.random.default_rng([seed, 11]).choice(
        pool, size=min(cell["check"]["stats_roots"], pool.size), replace=False)
    return ref.stats(entry.STATS_MODE, roots)


def measure(name: str, seed: int, seconds: float, traced: bool, t_start: float,
            device: str = "cuda", overrides: Optional[Dict] = None,
            patch: Optional[Callable] = None, root: str = ROOT):
    """The program's side of one run of the cell ``name``: (cell, its
    entry module, the run's readings, the device the reference runs
    on).  ``patch`` (a test's fault) runs in each process of the program
    before it is built."""
    from benchmark import runner
    cell = load_cell(name, root, overrides)
    world = int(cell["traffic"].get("world", 1))
    if world > 1:
        out = runner.drive_world(cell, seed, seconds, traced, t_start, device, patch)
    else:
        out = runner.drive(cell, seed, seconds, traced, device, t_start, patch=patch)
    dev = device if world == 1 else (f"{device}:0" if device == "cuda" else device)
    return cell, runner.entry_module(cell), out, dev


def run(name: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", overrides: Optional[Dict] = None,
        patch: Optional[Callable] = None, root: str = ROOT) -> Dict[str, Any]:
    """One run of the cell ``name``: the program's window, then, with
    its state freed, the reference's judgement."""
    import torch
    from benchmark import verify
    cell, entry, out, dev = measure(name, seed, seconds, traced, t_start, device,
                                    overrides, patch, root)
    ref = verify.Reference(cell, seed, dev)
    readings, diag, _ = entry.judge(ref, out)
    extra = {"forwards_per_root": entry.FORWARDS_PER_ROOT}
    if traced:
        # the mean subgraph of the cell's roots, for the FLOP and byte counts
        extra["subgraph"] = subgraph_stats(cell, entry, ref, seed)
    checks = check_numbers(cell, readings)
    world = int(cell["traffic"].get("world", 1))
    if torch.device(dev).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": world}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": world}
    info["memory_peak_bytes"] = out["memory_peak_bytes"]
    res = assemble(cell, out, checks, traced, info, entry.end_to_end(out), extra)
    res["_forbidden"] = out.get("forbidden", [])
    res["_graphs"] = out.get("graphs", "")
    res["_setup_split"] = out.get("setup_split", {})
    res["_diag"] = dict(diag, unit_s=[round(u, 4) for u in out.get("unit_s", [])])
    res["_end_to_end"] = dict(entry.end_to_end(out), setup_s=out["setup_s"])
    return res
