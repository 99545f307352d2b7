"""Named spans at the port's layer boundaries, read from a torch.profiler
trace.

:func:`span` is the port's one span mechanism.  While a torch profiler
records (the benchmark's traced slice, ``--trace_dir``, an operator's own
``torch.profiler.profile``), it opens a profiler range named ``name`` on
the calling thread; otherwise it returns one shared null context, after
one check of the profiler's state (0.6 µs on a CPU host with torch
2.13, where an unguarded range costs 13 µs with the profiler off).
Nothing is stored outside the profiler: a span is an event of its
trace, on the clock of the device events beside it, and its parent is
the span open around it on the same thread.  No flag or setting turns
them on.

The range is a function-scope one (``torch._C._profiler.
_RecordFunctionFast``, the range of torch's own compiled code), not
``torch.profiler.record_function``: a ``record_function`` range is a
user annotation, which Kineto mirrors on the device timeline as a
``gpu_user_annotation`` event covering every kernel launched inside it,
so a reader of the device's intervals would count an epoch's span as
device time (seen on an H100 with torch 2.11).  A function-scope range
stays on the host, and costs 1.8 µs where a user annotation costs 17 µs
(the same CPU host, profiler on).  ``args`` (ints or strings) are
shown in a trace recorded with ``record_shapes=True``.

Every name starts with ``sgnn.``, so that no span is taken for a CUDA
call (names that start with ``cu``):

============================  ======================================  ====================
span                          covers                                  args
============================  ======================================  ====================
``sgnn.epoch``                ``Trainer.run_epoch``                   epoch, mode
``sgnn.epoch.prepare``        tables, caches, the first-epoch
                              profile, the epoch arrays, the seed;
                              the device arrays and the lent
                              generators of a pass
``sgnn.epoch.steps``          a pass's batch loop
``sgnn.epoch.readback``       the host reads of losses, predictions
                              and the overflow (and the replicas'
                              checksums)
``sgnn.epoch.metrics``        ``Metrics.calc`` and ``log_epoch``
``sgnn.step``                 one batch: seed, inputs, run, copies    step
``sgnn.request``              ``predict_nodes``, ``embed_nodes``      ids
``sgnn.graphs.warmup``        a key's eager warm-up
``sgnn.graphs.capture``       a key's capture
``sgnn.graphs.replay``        ``replay()`` and the counters' credit
``sgnn.stage.sample``         ``Trainer._static_batches``
``sgnn.stage.membership``     the induced block (``induction.induce``)
``sgnn.stage.annotate``       ``induction.annotate``
``sgnn.stage.bfs``            the hop / DRNL BFS inside it
``sgnn.stage.forward``        the model and the loss
``sgnn.stage.backward``       ``loss.backward()``
``sgnn.stage.optimizer``      clip and Adam
``sgnn.collective.<op>``      ``all_gather``, ``reduce_scatter``,
                              ``all_reduce``, ``ring_shift``
``sgnn.collective.wait``      the join of an asynchronous
                              reduce-scatter or ring shift
``sgnn.collective.stage``     gloo's staging through host memory
============================  ======================================  ====================

The stages run inside the step functions: on the CPU, in an eager twin,
a gloo group, a key's warm-up and its capture.  A replay runs no Python,
so on a graphed Trainer a step holds ``sgnn.graphs.replay`` alone.
"""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str, **args):
    """A profiler range named ``name`` while a torch profiler records,
    else a null context."""
    if not _recording():
        return _NULL
    return _Range(name, (), args)
