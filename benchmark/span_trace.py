"""The program's spans in a traced slice (``shadow_gnn_torch/spans.py``:
every range named ``sgnn.*``), reduced with the slice's device events.

:func:`summarize` takes the events and the window that ``trace.py``'s
``summarize`` takes and returns what the readers of
``metrics/host_bound_idle_share.py``, ``metrics/epoch_boundary_ms.py``
and ``metrics/host_step_us.py`` read, under ``ctx["trace"]["program"]``:

* ``spans``: each name's count, host seconds and self seconds (its
  duration less the part that spans inside it cover);
* ``idle``: the slice's idle seconds (the gaps of the union of device
  intervals, as ``trace.py`` takes it) split three ways.  A gap is
  ended by a device operation; CUPTI's correlation id names the CUDA
  call that launched it (a CUDA graph's kernels share their
  ``cudaGraphLaunch``).  If that call ended after the gap began, the
  operation was not queued when the device went idle: the gap is
  ``host_bound_s``.  If it ended before, ``device_side_s``.  A gap that
  no operation ends (the slice's last) is host-bound; one whose
  operation's call is not in the trace is ``unmatched_s``;
* ``host_bound_by_span``: each host-bound gap's seconds put down to the
  innermost span open over each part of it, ``(outside spans)`` where
  none is;
* ``step_host_s``: the ``sgnn.step`` spans' count, their summed
  duration (``raw_s``), the part of it the host spent inside CUDA calls
  or on CUPTI's ``Command Buffer Full`` intervals (``calls_s``: a graph
  launch waits there while the device is behind, a synchronising call
  until it is done) and the rest, the host's own work (``host_s``).

This module is not yet called by ``trace.py``: ``trace.summarize``
would add ``"program": span_trace.summarize(events, window)`` to its
result (a change of a file the benchmark has).  Until then the three
readers find nothing and return None.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

from benchmark.trace import _is_device, _is_runtime, _union

PREFIX = "sgnn."
OUTSIDE = "(outside spans)"
BLOCKED = "Command Buffer Full"
UNMATCHED_SHARE = 0.05  # above this share of idle time the split is not read


def _innermost(spans: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """The time the spans cover, cut into segments, each with the name of
    the innermost span open over it (the latest to start)."""
    edges = sorted({t for s, e, _ in spans for t in (s, e)})
    starts = collections.defaultdict(list)
    for sp in spans:
        starts[sp[0]].append(sp)
    out, open_ = [], []
    for lo, hi in zip(edges, edges[1:]):
        open_ = [sp for sp in open_ if sp[1] > lo] + sorted(
            starts[lo], key=lambda sp: -sp[1])
        if open_:
            out.append((lo, hi, open_[-1][2]))
    return out


def _overlaps(items: List[Tuple], starts: List[int], lo: int, hi: int):
    """(item, ns) of each of the sorted, disjoint ``items`` ((start, end,
    ...); ``starts`` their starts) that overlaps [lo, hi)."""
    for it in items[max(0, bisect.bisect_right(starts, lo) - 1):]:
        if it[0] >= hi:
            break
        if it[1] > lo:
            yield it, min(it[1], hi) - max(it[0], lo)


def summarize(events, window: Tuple[int, int]) -> Dict:
    """The reduction above over ``window`` (start, end) in the events' ns
    clock."""
    w0, w1 = window
    dev, spans, calls = [], [], []
    call_end: Dict[int, int] = {}
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if _is_device(ev):
            if e > w0 and s < w1:
                dev.append((max(s, w0), min(e, w1), ev.correlation_id()))
        elif _is_runtime(name):
            call_end[ev.correlation_id()] = e
            calls.append((s, e))
        elif name == BLOCKED:
            calls.append((s, e))
        elif name.startswith(PREFIX) and e > w0 and s < w1:
            spans.append((s, e, name))
    _, merged = _union([(s, e) for s, e, _ in dev])
    # the operations that start each busy interval, by start
    first = collections.defaultdict(list)
    for s, _, corr in dev:
        first[s].append(corr)
    gaps, edge = [], w0
    for s, e in merged:
        if s > edge:
            gaps.append((edge, s, first[s]))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1, None))
    segs = _innermost(spans)
    seg_starts = [s for s, _, _ in segs]
    idle = dict.fromkeys(("host_bound_s", "device_side_s", "unmatched_s"), 0)
    by_span: Dict[str, int] = collections.Counter()
    for gs, ge, corrs in gaps:
        ends = [call_end[c] for c in corrs or () if c in call_end]
        if corrs is not None and not ends:
            idle["unmatched_s"] += ge - gs
        elif corrs is not None and max(ends) <= gs:
            idle["device_side_s"] += ge - gs
        else:
            idle["host_bound_s"] += ge - gs
            inside = 0
            for (_, _, name), ns in _overlaps(segs, seg_starts, gs, ge):
                by_span[name] += ns
                inside += ns
            if ge - gs > inside:
                by_span[OUTSIDE] += ge - gs - inside
    stats: Dict[str, Dict] = {}
    for s, e, name in spans:
        st = stats.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0})
        st["count"] += 1
        st["host_s"] += (e - s) * 1e-9
    for s, e, name in segs:
        stats[name]["self_s"] += (e - s) * 1e-9
    steps = [(s, e) for s, e, name in spans if name == "sgnn.step"]
    raw = sum(e - s for s, e in steps)
    _, merged = _union(calls)
    starts = [s for s, _ in merged]
    held = sum(ns for s, e in steps for _, ns in _overlaps(merged, starts, s, e))
    return {
        "spans": stats,
        "idle": {k: v * 1e-9 for k, v in idle.items()},
        "host_bound_by_span": {k: v * 1e-9 for k, v in by_span.most_common()},
        "step_host_s": {"count": len(steps), "host_s": (raw - held) * 1e-9,
                        "raw_s": raw * 1e-9, "calls_s": held * 1e-9},
    }


def program(ctx) -> Optional[Dict]:
    """The slice's ``program`` summary where a reader may take it: the
    slice holds an ``sgnn.epoch`` span, and its unmatched idle time is at
    most ``UNMATCHED_SHARE`` of its idle time; else None."""
    p = (ctx.get("trace") or {}).get("program")
    if not p or not p["spans"].get("sgnn.epoch", {}).get("count"):
        return None
    idle = sum(p["idle"].values())
    if idle > 0 and p["idle"]["unmatched_s"] > UNMATCHED_SHARE * idle:
        return None
    return p
