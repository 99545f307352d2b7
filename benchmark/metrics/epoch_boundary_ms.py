"""The host-bound idle time of the epoch loop a traced epoch: the
host-bound gaps (``span_trace.py``) put down to ``sgnn.epoch.prepare``,
``sgnn.epoch.readback``, ``sgnn.epoch.metrics`` or ``sgnn.epoch``
itself (``Trainer.run_epoch``'s boundary), over the slice's
``sgnn.epoch`` spans, in ms."""
from benchmark import span_trace

BOUNDARY = ("sgnn.epoch", "sgnn.epoch.prepare", "sgnn.epoch.readback",
            "sgnn.epoch.metrics")


def read(ctx):
    p = span_trace.program(ctx)
    if p is None:
        return None
    by = p["host_bound_by_span"]
    return 1e3 * sum(by.get(k, 0.0) for k in BOUNDARY) / p["spans"]["sgnn.epoch"]["count"]
