"""The host's own work a step in the traced slice: the ``sgnn.step``
spans' duration less the time the host spent inside CUDA calls or on a
full launch queue (``span_trace.py``: a graph launch waits there while
the device is behind), over their count, in µs."""
from benchmark import span_trace


def read(ctx):
    p = span_trace.program(ctx)
    if p is None or p["step_host_s"]["count"] <= 0:
        return None
    return 1e6 * p["step_host_s"]["host_s"] / p["step_host_s"]["count"]
