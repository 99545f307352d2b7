"""CUDA-graph capture and replay of a Trainer's steps.

The port's counterpart of the JAX package's compiled programs: the
jitted TRAIN and eval epochs (``shadow_gnn_tpu/train/pipeline.py:
_make_epoch_fn``), the serve program of each request bucket
(``_serve_fn``), which sample and induce inside the program, the
jitted ``shard_map`` steps of the partitions (``_run_partition_epoch``)
and the first-epoch profile's chunk (``_profile_chunk_fn``).  JAX's
epoch scan and chunking are TPU mechanics and are not carried over;
what is carried over is the compiled step.  A step here is a function
of static buffers (``Trainer._static_train``, ``_static_eval``,
``_static_serve``, ``_static_profile``, and the partitioned step of
``parallel/partition.py:make_step``): its only inputs are the tensors of
:meth:`StepGraphs.inputs` (roots, table rows, labels, weights, the
dropedge seed), written before each call, and everything else it reads
(the graph's CSR, the PPR tables, the subgraph caches, the feature
table, the model, Adam's state) stays where it is between calls.  A
branch with a built cache gathers its batch; any other samples and
induces it inside the step.  On a graphed Trainer each step key (the
kind, the mode, the data mode or the bucket, the batch size, which
branches are cached) is

1. run once eagerly on a side stream: the warm-up, which is a real
   step of the run (it initialises Adam's state and loads every kernel);
2. captured in a ``torch.cuda.CUDAGraph`` on its next call, from the
   memory pool that the Trainer's graphs share, and replayed at once;
3. replayed on every later call.

Two device generators are registered with every graph: the dropout
generator (:attr:`StepGraphs.generator`) and the samplers' generator
(:attr:`StepGraphs.sampler`: the khop picks and the ``ppr_st``
uniforms).  A pass loads the epoch generator's state into each and
gives the state back after (:meth:`StepGraphs.dropout`,
:meth:`StepGraphs.sampling`; a request loads a generator seeded with
``SERVE_SEED``), so the replays draw the eager steps' masks and
picks.  The kernel wrappers count their launches in Python, and the
collectives their calls and bytes, which a replay does not run: the
capture's counts are taken back and credited on every replay instead
(:func:`launch_counters`).

A partitioned Trainer whose process group is NCCL captures its steps
with their collectives (``parallel/collectives.py``).  Every rank warms
up, captures and replays the same keys in the same order: the keys and
the order of the steps are the same on every rank, so no rank captures
while another runs a collective eagerly.  A gloo group stages CUDA
tensors through host memory, which a graph cannot hold: its steps run
eagerly.  An NCCL communicator waits, on destruction, for every graph
that holds its collectives: leaving the group
(``parallel/multihost.py:shutdown``) destroys every graph first
(:func:`release_all`).

A graph reads the tensors it was captured with.  Each key's graph keeps
the objects those belong to (its ``deps``: the model, the feature
table, the caches and, for a TRAIN step, the optimizer and its state)
and is captured anew, after a new warm-up, when one of them was
replaced (a rebuilt cache, a loaded optimizer state);
``model.load_state_dict`` copies in place and keeps them.  A capture or
replay that fails raises: nothing falls back to the eager step.  On the
CPU, with ``cuda_graphs=False`` and inside :meth:`StepGraphs.paused`,
the same step functions are called directly.
"""
from __future__ import annotations

import collections
import contextlib
import time
import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from shadow_gnn_torch.spans import span


# every StepGraphs that captured a graph (release_all)
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


def release_all():
    """Destroy every captured graph of the process.  An NCCL communicator,
    on destruction, waits for every CUDA graph that holds its collectives
    (a group of more than one rank then never finishes leaving), so
    ``parallel/multihost.py:shutdown`` calls this first."""
    for sg in list(_LIVE):
        sg.release()


def launch_counters():
    """(holder, name) of every kernel launch counter of the port: the
    packed wrappers' (calls, per mode, per norm), the attention
    wrappers' (per level) and the BFS kernel's; and the collectives'
    calls and bytes.  A holder is the wrapper or a dict."""
    from shadow_gnn_torch.ops import bfs, gat, packed
    from shadow_gnn_torch.parallel import collectives
    out = [(packed.packed_spmm, "calls"), (bfs.bfs_hops_multi, "launches"),
           (collectives.stats, "calls"), (collectives.stats, "bytes")]
    for fn in (packed.packed_spmm, packed.packed_spmm_t):
        out += [(fn, "launches"), (fn, "launches_bf16")]
        out += [(fn.launches_by_norm, n) for n in packed.NORMS]
    for fn in (gat.gat_attention, gat.gat_attention_bwd):
        out += [(fn, "launches"), (fn, "launches_bf16")]
    return out


def _read(holder, name):
    return holder[name] if isinstance(holder, dict) else getattr(holder, name)


def _write(holder, name, value):
    if isinstance(holder, dict):
        holder[name] = value
    else:
        setattr(holder, name, value)


def counter_values(counters):
    return [_read(h, n) for h, n in counters]


def take_delta(counters, before) -> Tuple[tuple, ...]:
    """The counts added since ``before`` as (holder, name, delta), each
    counter set back to its ``before`` value."""
    delta = []
    for (h, n), b in zip(counters, before):
        d = _read(h, n) - b
        if d:
            delta.append((h, n, d))
            _write(h, n, b)
    return tuple(delta)


def credit(delta):
    """Add a captured step's launches to the counters: one replay."""
    for h, n, d in delta:
        _write(h, n, _read(h, n) + d)


class Graph(NamedTuple):
    """One captured step: the graph, its static outputs, the objects it
    reads (``deps``) and the launch counts of one replay (``delta``)."""
    graph: Any
    outputs: Any
    deps: tuple
    delta: tuple


def _same(a: Optional[tuple], b: tuple) -> bool:
    return a is not None and len(a) == len(b) and all(x is y for x, y in zip(a, b))


class StepGraphs:
    """The CUDA graphs of one Trainer's steps, one per key, with their
    static input buffers, their shared memory pool and the dropout and
    sampler generators registered with each.  ``enabled`` False (the CPU,
    an eager twin, a gloo-partitioned Trainer) runs every step function
    directly.

    ``replays`` counts the replays by key, ``warmups`` the eager warm-up
    steps and ``captures`` the captures (a key captured again after one
    of its deps was replaced counts twice); ``capture_s`` sums the
    seconds of the captures and ``pool_bytes`` the device memory they
    reserved (the pool)."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.enabled = bool(enabled) and device.type == "cuda"
        self.graphs: Dict[tuple, Graph] = {}
        self.buffers: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._warmed: Dict[tuple, tuple] = {}
        self._paused = 0
        self._pool = None
        self._side = None
        self.generator = (torch.Generator(device=device) if self.enabled else None)
        self.sampler = (torch.Generator(device=device) if self.enabled else None)
        self.replays: collections.Counter = collections.Counter()
        self.warmups: collections.Counter = collections.Counter()
        self.captures: collections.Counter = collections.Counter()
        self.capture_s = 0.0
        self.pool_bytes = 0

    # ------------------------------------------------------------------
    def inputs(self, key: tuple, **values) -> Dict[str, torch.Tensor]:
        """The static input buffers of ``key``, made on its first call
        (a tensor's shape and dtype, a 0-d int64 for an int), with
        ``values`` written into them: tensors copied, ints filled."""
        buf = self.buffers.get(key)
        if buf is None:
            with torch.inference_mode(False):
                buf = self.buffers[key] = {
                    k: (torch.empty(v.shape, dtype=v.dtype, device=self.device)
                        if isinstance(v, torch.Tensor)
                        else torch.zeros((), dtype=torch.int64, device=self.device))
                    for k, v in values.items()}
        for k, v in values.items():
            if isinstance(v, torch.Tensor):
                buf[k].copy_(v)
            else:
                buf[k].fill_(int(v))
        return buf

    def dropout(self, generator: Optional[torch.Generator]):
        """The dropout generator of a pass (:meth:`_lend`)."""
        return self._lend(self.generator, generator)

    def sampling(self, generator: Optional[torch.Generator]):
        """The samplers' generator of a pass or a request (:meth:`_lend`)."""
        return self._lend(self.sampler, generator)

    @contextlib.contextmanager
    def _lend(self, registered: Optional[torch.Generator],
              generator: Optional[torch.Generator]):
        """On a graphed Trainer ``registered`` (a generator registered with
        every graph) holding ``generator``'s state within the block, which
        ``generator`` gets back after it; else ``generator`` itself."""
        if not self.enabled or generator is None or registered is None:
            yield generator
            return
        registered.set_state(generator.get_state())
        try:
            yield registered
        finally:
            generator.set_state(registered.get_state())

    @contextlib.contextmanager
    def paused(self):
        """Within the block every step runs eagerly and nothing is
        captured (a check that swaps a kernel for its plain version);
        the graphs captured before it stay."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def drop(self, match: Callable[[tuple], bool] = lambda key: True):
        """Forget the graphs (and warm-ups) of the keys ``match`` picks."""
        for key in [k for k in self.graphs if match(k)]:
            del self.graphs[key]
        for key in [k for k in self._warmed if match(k)]:
            del self._warmed[key]

    def release(self):
        """Destroy every captured graph (``CUDAGraph.reset``, once the
        device is idle) and forget it with its warm-up."""
        if self.graphs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for g in self.graphs.values():
            g.graph.reset()
        self.drop()

    # ------------------------------------------------------------------
    def run(self, key: tuple, deps: tuple, fn: Callable[[], Any]):
        """``fn()``'s outputs for the step ``key`` (static tensors on a
        graphed Trainer: read them before the next step of the key):
        directly where graphs are off or paused; else the key's warm-up
        on its first call, a capture and replay on its second, a replay
        after.  ``deps``: the objects whose tensors ``fn`` reads."""
        if not self.enabled or self._paused:
            return fn()
        g = self.graphs.get(key)
        if g is not None and not _same(g.deps, deps):
            self.drop(lambda k: k == key)
            g = None
        if g is None:
            if not _same(self._warmed.get(key), deps):
                self._warmed[key] = deps
                self.warmups[key] += 1
                with span("sgnn.graphs.warmup"):
                    return self._warm(fn)
            with span("sgnn.graphs.capture"):
                g = self.graphs[key] = self._capture(deps, fn)
            self.captures[key] += 1
        with span("sgnn.graphs.replay"):
            g.graph.replay()
            credit(g.delta)
        self.replays[key] += 1
        return g.outputs

    def _warm(self, fn):
        """``fn()`` on a side stream, ordered after and before the
        current stream's work."""
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = fn()
        cur.wait_stream(self._side)
        return out

    def _capture(self, deps, fn) -> Graph:
        """Capture ``fn`` (:meth:`_record`); the launches its capture
        counted are taken back and credited on each replay."""
        counters = launch_counters()
        before = counter_values(counters)
        _LIVE.add(self)
        t0 = time.perf_counter()
        graph, outputs = self._record(fn)
        self.capture_s += time.perf_counter() - t0
        return Graph(graph, outputs, deps, take_delta(counters, before))

    def _record(self, fn):
        """(a CUDA graph of ``fn()`` from the shared pool, with the
        dropout and sampler generators registered, and its static
        outputs); the device memory the capture reserved is added to
        ``pool_bytes``."""
        with torch.cuda.device(self.device):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            graph.register_generator_state(self.sampler)
            with torch.cuda.graph(graph, pool=self._pool):
                outputs = fn()
            self.pool_bytes += torch.cuda.memory_reserved() - reserved
        return graph, outputs

    def summary(self) -> str:
        """One line: the graphs, their replays, warm-ups and captures, the
        capture seconds and the pool's MiB."""
        if not self.enabled:
            return "CUDA graphs off: every step runs eagerly"
        kinds = collections.Counter(k[0] for k in self.graphs)
        captures = f"{sum(self.captures.values())} captures"
        again = sum(n - 1 for n in self.captures.values())
        if again:
            captures += f" ({again} of a key captured before)"
        return (f"{len(self.graphs)} graphs ({dict(kinds)}), "
                f"{sum(self.replays.values())} replays, "
                f"{sum(self.warmups.values())} warm-up steps, {captures}, capture "
                f"{self.capture_s:.2f}s, pool {self.pool_bytes / 2**20:.0f} MiB")
