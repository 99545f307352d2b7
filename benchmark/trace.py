"""The traced slice of a run: ``torch.profiler`` over whole epochs, its
events kept in memory and reduced here to what the per-layer readers
take.  No trace file is written.

* ``busy_s``: the union of the intervals in which any operation (a
  kernel, a copy, a fill) ran on the device, so that overlapping
  kernels (NCCL beside compute) count once;
* ``kernel_s``: seconds of device time by operation name (a sum, for a
  kernel's own time);
* ``nccl_busy_s``: the union of the NCCL kernels' intervals;
* ``runtime_calls``: the host's calls into the CUDA libraries (``cuda*``, ``cu*``);
* ``device_ops`` / ``idle_gaps``: the ten operations that took most
  device time, and the idle time between device operations by the
  innermost host operation that was running in it.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, List, Tuple

LABELLED_GAPS = 2000    # the longest idle gaps, each labelled by its host operation


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, the merged intervals) of [start, end) intervals."""
    total, merged = 0, []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                total += e - merged[-1][1]
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
            total += e - s
    return total, merged


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type()) or "cuda" in str(ev.device_type())


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn")


def summarize(events, window: Tuple[int, int]) -> Dict:
    """Reduce Kineto events to the summary above, over ``window`` (start,
    end) in the events' ns clock."""
    w0, w1 = window
    dev, host = [], []
    by_name: Dict[str, int] = collections.Counter()
    nccl = []
    calls = 0
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if e <= w0 or s >= w1:
            continue
        name = ev.name()
        if _is_device(ev):
            s, e = max(s, w0), min(e, w1)
            dev.append((s, e))
            by_name[name] += e - s
            if "nccl" in name.lower():
                nccl.append((s, e))
        elif _is_runtime(name):
            calls += 1
        else:
            host.append((s, e, name))
    busy, merged = _union(dev)
    nccl_busy, _ = _union(nccl)
    gaps = []
    edge = w0
    for s, e in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    host.sort()
    host_starts = [h[0] for h in host]
    idle = collections.Counter()
    gaps.sort(key=lambda g: g[0] - g[1])
    idle["(shorter gaps)"] = sum(ge - gs for gs, ge in gaps[LABELLED_GAPS:])
    for gs, ge in gaps[:LABELLED_GAPS]:
        mid = (gs + ge) // 2
        inner = None
        # the host operations that began at most 400 operations before
        at = bisect.bisect_right(host_starts, mid)
        for hs, he, hn in host[max(0, at - 400):at]:
            if he >= mid and (inner is None or he - hs < inner[1] - inner[0]):
                inner = (hs, he, hn)
        idle[inner[2] if inner else "(no host operation)"] += ge - gs
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "nccl_busy_s": nccl_busy * 1e-9,
        "kernel_s": {k: v * 1e-9 for k, v in by_name.items()},
        "runtime_calls": calls,
        "device_ops": [[k[:160], v * 1e-9] for k, v in by_name.most_common(10)],
        "idle_gaps": [[k[:160], v * 1e-9] for k, v in idle.most_common(10)],
    }


class Tracer:
    """``with tracer.window():`` profiles the block (the CPU and, on a
    card, CUDA); :meth:`summary` reduces what it recorded."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.span = (0, 0)

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts) as prof:
            if self.cuda:
                torch.cuda.synchronize()
            t0 = time.time_ns()
            yield
            if self.cuda:
                torch.cuda.synchronize()
            t1 = time.time_ns()
        self.prof = prof
        self.span = (t0, t1)

    def summary(self) -> Dict:
        events = self.prof.profiler.kineto_results.events()
        # Kineto's clock: take the window from the events themselves when
        # the two clocks disagree (the profiler's ns may be monotonic)
        t0, t1 = self.span
        starts = [ev.start_ns() for ev in events]
        if starts and not (t0 - 60e9 < min(starts) < t1 + 60e9):
            t0 = min(starts)
            t1 = max(ev.start_ns() + ev.duration_ns() for ev in events)
        return summarize(events, (t0, t1))
