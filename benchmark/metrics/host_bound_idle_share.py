"""The host-bound part of the device's idle share of the traced slice:
the idle gaps that end with an operation whose CUDA call had not
returned when the gap began (``span_trace.py``), over the slice's wall
time; the rest of ``device_idle_share`` is device-side (gaps inside
work that was queued) or unmatched."""
from benchmark import span_trace


def read(ctx):
    p = span_trace.program(ctx)
    t = ctx.get("trace")
    if p is None or t["window_s"] <= 0:
        return None
    return 100.0 * p["idle"]["host_bound_s"] / t["window_s"]
