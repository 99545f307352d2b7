"""Training and serving pipeline: data -> PPR tables -> subgraph cache
-> model -> loops.

The port of the JAX package's ``train/pipeline.py`` Trainer for the
node and link tasks: per-mode device graphs, per-branch samplers
(``ppr``, ``ppr_st``, ``khop``, ``nodeIID``; a ``full`` train sampler is
``nodeIID`` for the adjacency-free backbones) and their induction plans,
per-mode PPR top-k tables (native host push + the reference's bin
cache), the bit-packed subgraph cache of each deterministic PPR branch
of the node task, the preprocessing
(label inputs and feature / label smoothening, ``train/preproc.py``),
training (:meth:`Trainer.train`: epochs of TRAIN and VALID, best-model
selection, final passes), point-query serving
(:meth:`Trainer.predict_nodes` / :meth:`Trainer.embed_nodes`), the
reload of a saved run (:meth:`Trainer.load_run`, the ``retrain_dir``
hyperparameter), the inference passes of a reloaded model
(:meth:`Trainer.inference`) and the full-graph matrices that the
post-processing reads (:meth:`Trainer.predict_full` /
:meth:`Trainer.embed_full`).

Differences from the JAX Trainer:
* everything runs on ``device`` (default ``"cuda"``; CUDA absent
  raises), one batch at a time: there are no epoch-scan or chunk
  programs.  Where JAX compiles its epochs and its serve programs, a
  CUDA Trainer (``cuda_graphs=True``, the default) captures each step in
  a CUDA graph and replays it (``train/graphs.py``): the TRAIN step
  (each branch's batch, forward, backward, clip, Adam), the eval step of
  the VALID/TEST passes, ``inference`` and ``predict_full`` /
  ``embed_full``, and each serving bucket of ``predict_nodes`` /
  ``embed_nodes``.  A step is a function of static buffers
  (``_static_train``, ``_static_eval``, ``_static_serve``): a branch
  whose mode has a built subgraph cache gathers from it, any other
  (khop, nodeIID, ppr_st, a cache over its budget, ``disable_cache``,
  ``inference``, the link task) samples and induces inside the step, as
  JAX's ``_sample_branch_batches`` does inside its programs.  The
  first-epoch profile (``_static_profile``) and, where the process
  group is NCCL, the partitioned TRAIN and eval steps with their
  collectives (``parallel/partition.py:make_step``) replay graphs too.
  The CPU, an eager twin (``cuda_graphs=False``) and a gloo-partitioned
  Trainer call the same functions directly;
* ``partition`` (``dp``, ``feat``, ``edge``; ``parallel/``) runs inside
  a process group, one Trainer a rank (``parallel/multihost.py``): each
  rank builds the same Trainer from the same seed, draws the same epoch
  permutations, takes its contiguous share of every batch's columns and
  gets the whole batch's predictions back by an all-gather, so the
  metrics are the global batch's.  Every epoch of a partitioned Trainer
  runs partitioned (JAX's multi-process rule: ``feat`` and ``edge``
  evaluate partitioned, and so does ``dp``, through the ``feat`` form).
  The dropout and dropedge seeds are drawn per rank from (the epoch's
  seed, the rank), rank 0 taking the epoch's own;
* dropout masks come from a ``torch.Generator`` on the device and
  dropedge seeds from one on the host, both seeded per epoch from
  ``rng_np``; the masks themselves differ from JAX's.  ``rng_np`` is
  consumed in the JAX Trainer's order: the first-epoch subgraph
  profile (``profiler``, on by default, :meth:`_profile_epoch`) draws
  one permutation, then each epoch a permutation and one seed, so the
  epoch permutations match a JAX run of the same seed with the profile
  on or off in both.  The profile pass samples (its khop picks from a
  generator seeded with 0) and counts on the device; it runs no model
  and launches no aggregation or attention kernel.  Its edge count reads
  the packed bits of a packed model's batches, where JAX's packed path
  counts a placeholder block (0 edges);
* ``use_device_ppr=True`` runs the power iteration of
  ``sampling/ppr.py:ppr_power_device`` on ``device``; None plans, which
  picks the host push, as JAX's planner does;
* ``trace_dir`` (``--trace_dir``): TRAIN epoch 1 runs under
  ``torch.profiler`` (CPU and, on a card, CUDA activities) and its
  Chrome trace, with the port's ``sgnn.*`` spans (``spans.py``), is
  written into that directory, where JAX writes a ``jax.profiler``
  trace of the same epoch;
* serving builds the mode's subgraph cache on the first request (the
  JAX Trainer builds it in its first epoch of that mode);
* a ``khop`` branch draws its picks from the epoch's sampling
  generator (TRAIN and evaluation passes) and, in serving and the
  full-graph passes, from a generator seeded with ``SERVE_SEED`` on
  every request or call, so the same ids get the same answer; only
  ``ppr`` branches are cached, the others sample and induce every batch;
* the link task (``edge_set`` splits: an entity is an edge, whose two
  end nodes are a subgraph's targets) trains and evaluates: it samples
  every batch (nothing is cached, as in JAX), its PPR tables cover every
  node, indexed by node id and shared by the modes, and a ``ppr_st``
  branch races over 2k-wide tables in TRAIN (its uniforms from the
  epoch's sampling generator) and reads them as ``ppr`` in VALID/TEST.
  TRAIN negatives come from the JAX Trainer's own numpy stream, drawn
  in its order (without its prefetch thread).  Serving and the
  full-graph passes refuse it, as JAX asserts;
* checkpoints are the port's own ``torch.save`` files; a run dir of
  the JAX package is refused (``train/logger.py:find_checkpoint``);
* the precision trade (``matmul_precision``, ``compute_dtype``,
  ``feat_dtype``) is carried by ``ModelConfig`` and the feature table,
  never by a process-wide setting (``tensorfloat32`` switches TF32 on
  around each product only, ``ops/precision.py``).  A bf16 feature
  table is widened to the compute dtype at the gather (exact), so an
  f32 model sees the rounded features in f32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
from shadow_gnn_torch.data.graph import DeviceGraph, RawGraph, is_undirected
from shadow_gnn_torch.nn.layers import init_params
from shadow_gnn_torch.nn.model import (ADJ_FREE, DeepGNN, ModelConfig, predict_fn,
                                       row_losses)
from shadow_gnn_torch.sampling import cache as cache_mod
from shadow_gnn_torch.sampling import ppr as ppr_mod
from shadow_gnn_torch.sampling.batch import (DIM_1HOT_HOP, SamplerConfig,
                                             SubgraphBatch, default_n_pad,
                                             no_overflow, total_overflow)
from shadow_gnn_torch.sampling.induction import (PLAN_GATHER_BUDGET, bucket_cap,
                                                 plan_gather_bytes,
                                                 plan_ppr_induction)
from shadow_gnn_torch.sampling.samplers import PPRTables, sample_subgraphs
from shadow_gnn_torch.spans import span
from shadow_gnn_torch.train.config import DATA_METRIC, decouple_ensemble
from shadow_gnn_torch.train.graphs import StepGraphs
from shadow_gnn_torch.train.logger import Logger, find_checkpoint
from shadow_gnn_torch.train.metrics import Metrics
from shadow_gnn_torch.train.profiler import SubgraphProfiler, batch_stats

CLIP_NORM = 5.0                 # reference models.py:223
SERVE_SEED = 0                  # the khop picks of every request


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return dev


@contextlib.contextmanager
def _epoch_trace(trace_dir: Optional[str], device: torch.device):
    """Within the block, torch.profiler records the CPU and, on a card,
    CUDA; its Chrome trace is then written into ``trace_dir``.  Nothing
    is recorded when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"train_epoch1_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"[trace] TRAIN epoch 1 -> {path}")


def weighted_loss_parts(cfg: ModelConfig, logits: torch.Tensor,
                        labels: torch.Tensor, weights: torch.Tensor):
    """(numerator, weight sum) of the reference loss with per-row
    weights (0 on tail-batch padding rows)."""
    return (row_losses(cfg, logits, labels) * weights).sum(), weights.sum()


def weighted_loss_fn(cfg: ModelConfig, logits, labels, weights) -> torch.Tensor:
    """Reference loss (models.py:156-166) with tail-batch padding masked
    by per-row weights in {0, 1}."""
    num, den = weighted_loss_parts(cfg, logits, labels, weights)
    return num / torch.clamp(den, min=1.0)


@torch.no_grad()
def clip_grad_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm: when the global L2 norm g of all
    gradients reaches ``max_norm``, scale them by max_norm / g, with no
    epsilon (torch.nn.utils.clip_grad_norm_ divides by g + 1e-6).
    Multi-tensor kernels, no host sync.  Returns g."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.nn.utils.get_total_norm(grads, 2.0)
    coef = torch.where(norm >= max_norm, max_norm / norm, torch.ones_like(norm))
    torch._foreach_mul_(grads, coef)
    return norm


def make_optimizer(params, lr: float) -> torch.optim.Optimizer:
    """optax.adam(lr) with its defaults (the clip is applied to the
    gradients first, by :func:`clip_grad_global_norm_`).  On a card it
    is ``capturable``: its step count lives on the device and the bias
    corrections are formed there in f32 (as optax forms them), so a CUDA
    graph can hold the update; the eager and the graphed steps use the
    same arithmetic.  The CPU, where torch refuses ``capturable``, keeps
    the count on the host and forms them in double."""
    params = list(params)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=any(p.is_cuda for p in params))


def _check_partition(partition: str, partition_devices: int, batch_size: int):
    """A partitioned Trainer runs on a rank of a process group whose
    world size is ``partition_devices`` (0 = any) and divides the batch
    size."""
    from shadow_gnn_torch.parallel import multihost as mh
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            f"partition {partition!r} runs inside a process group, one Trainer "
            "a rank: call parallel.multihost.initialize first (the CLI's "
            "--partition spawns the ranks, --distributed joins a launcher's)")
    world = mh.world_size()
    if partition_devices not in (0, world):
        raise ValueError(f"partition_devices={partition_devices} but the process "
                         f"group has {world} ranks")
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} does not divide by the world "
                         f"size {world}: every rank takes an equal share of a "
                         "batch's columns")


def graphs_allowed(partition: str) -> bool:
    """Whether a Trainer of ``partition`` may capture its steps: one
    that is not partitioned, or a rank of an NCCL group, whose
    collectives a CUDA graph holds (gloo stages CUDA tensors through host
    memory)."""
    from shadow_gnn_torch.parallel import multihost as mh
    return partition == "none" or mh.backend() == "nccl"


def rank_seed(seed: int, rank: int) -> int:
    """The dropout / dropedge seed of ``rank`` in an epoch of seed
    ``seed`` (rank 0 keeps ``seed``)."""
    return (seed ^ (rank * 0x9E3779B9)) & (2**63 - 1)


@dataclasses.dataclass
class EpochRNG:
    """One epoch's random streams: dropout masks on the device, dropedge
    seeds on the host (drawn without a device sync), and the khop
    samplers' picks on the device."""

    dropout: torch.Generator
    dropedge: torch.Generator
    sample: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device: torch.device) -> "EpochRNG":
        return cls(torch.Generator(device=device).manual_seed(seed),
                   torch.Generator().manual_seed(seed ^ 0x5BD1E995),
                   torch.Generator(device=device).manual_seed(seed ^ 0x2545F491))

    def dropedge_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self.dropedge))


class Trainer:
    def __init__(self, name_data: str, dir_data: str, raw: RawGraph,
                 parsed: Dict[str, Any], metrics: Optional[Metrics] = None,
                 logger: Optional[Logger] = None, seed: int = 0, device="cuda",
                 packed_adj: bool = False, matmul_precision: Optional[str] = None,
                 compute_dtype: str = "float32", feat_dtype: str = "float32",
                 fused_gat: Optional[bool] = None,
                 use_device_ppr: Optional[bool] = None,
                 partition: str = "none", partition_devices: int = 0,
                 cuda_graphs: bool = True):
        """``metrics`` defaults to the dataset's metric (DATA_METRIC,
        else accuracy) and ``logger`` to one that writes no files.
        ``use_device_ppr``: True computes the PPR tables by the power
        iteration on ``device``, False by the host push, None as
        ``ppr_mod.plan_device_ppr`` picks (the host push).
        ``matmul_precision`` (None = "float32", "bfloat16" or
        "tensorfloat32"),
        ``compute_dtype`` and ``feat_dtype`` ("float32" or "bfloat16") are
        the JAX Trainer's arguments of those names; the model checks the
        first two.  ``fused_gat`` (None, True or False) is accepted as
        the JAX Trainer accepts it, where False picks XLA's dense score
        chain over the Pallas kernel, the same function: the port has one
        implementation of it on the card, the CUDA kernels of
        ``ops/gat.py``, which every value launches.
        ``partition`` ("none", "dp", "feat" or "edge") and
        ``partition_devices`` (0 or the world size) are the JAX
        Trainer's: a partitioned Trainer is built on every rank of an
        initialised process group whose world size divides the batch
        size (``parallel/multihost.py:initialize``; the CLI's
        ``--partition`` spawns the ranks).  ``cuda_graphs`` (True) lets a
        CUDA Trainer replay its steps, cached, sampled or partitioned
        over NCCL, from CUDA graphs; False runs them eagerly, the same
        functions (the eager twin that ``chip_smoke.py`` compares); the
        CPU and a gloo group ignore it (:func:`graphs_allowed`)."""
        if partition not in ("none", "dp", "feat", "edge"):
            raise ValueError(f"unsupported partition {partition!r}")
        if feat_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported feat_dtype {feat_dtype!r}")
        if fused_gat not in (None, True, False):
            raise ValueError(f"fused_gat must be None, True or False, not "
                             f"{fused_gat!r}")
        self.device = resolve_device(device)
        self.name_data = name_data
        self.dir_data = dir_data
        self.arch = parsed["arch_gnn"]
        self.params_train = parsed["params_train"]
        if metrics is None:
            metrics = Metrics(name_data, self.arch["loss"] == "sigmoid",
                              DATA_METRIC.get(name_data, "accuracy"),
                              int(self.params_train["term_window_size"]))
        self.metrics = metrics
        self.logger = logger if logger is not None else Logger(
            metrics, "", no_log=True,
            term_window_size=int(self.params_train["term_window_size"]),
            term_window_aggr=self.params_train["term_window_aggr"])
        self.sampler_cfg_train = parsed["config_sampler_train"]
        self.sampler_cfg_preproc = parsed["config_sampler_preproc"]
        self.config_data = parsed["config_data"]
        self.task = raw.prediction_task
        self.seed = seed
        self.rng_np = np.random.default_rng(seed)
        # link-task negatives: their own stream (the JAX Trainer's) and
        # the sorted keys of the TRAIN graph's edges, built on first use
        self._neg_rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0x9e3779b9]))
        self._neg_edge_keys: Optional[np.ndarray] = None
        self.batch_size = self.sampler_cfg_train["batch_size"]
        self.partition = partition
        self.partition_devices = partition_devices
        if partition != "none":
            _check_partition(partition, partition_devices, self.batch_size)
        self._partition_fns: Dict[tuple, Any] = {}
        # partitioned TRAIN epochs run (JAX counts the device programs
        # of them, one epoch-scan program an epoch; the port runs one
        # step a batch, so this counts the epochs)
        self.partition_train_dispatches = 0
        self.is_transductive = raw.is_transductive
        g_full = DeviceGraph.from_csr(raw.indptr_full, raw.indices_full,
                                      self.device)
        self.graph = {VALID: g_full, TEST: g_full}
        self.graph[TRAIN] = (g_full if raw.indptr_train is None else
                             DeviceGraph.from_csr(raw.indptr_train,
                                                  raw.indices_train, self.device))
        self._host_adj = {m: raw.adj(m) for m in (TRAIN, VALID, TEST)}
        self.num_nodes = raw.num_nodes
        self.undirected = is_undirected(raw.indptr_full, raw.indices_full)
        self.feat_np = np.asarray(raw.feat_full, dtype=np.float32)
        self.dim_feat_raw = self.dim_feat_smooth = self.feat_np.shape[1]
        self.dim_label_smooth = 0
        self.label_np = label = raw.label_full
        if self.task == "link":
            self.entity_set, self.num_classes = raw.edge_set, 1
        else:
            self.entity_set = raw.node_set
            self.num_classes = (
                int(label[~np.isnan(label.astype(np.float64))].max()) + 1
                if label.ndim == 1 else label.shape[1])
        self.num_targets = 2 if self.task == "link" else 1
        # preprocessing before the feature table is frozen: widens
        # feat_np and sets dim_feat_smooth / dim_label_smooth
        self.preproc_log: Dict[str, float] = {}
        if (self.arch["feature_smoothen"] != "none"
                or self.arch["use_label"] != "none"):
            from shadow_gnn_torch.train.preproc import preprocess_signals
            (self.feat_np, self.dim_feat_smooth, self.dim_label_smooth,
             self.preproc_log) = preprocess_signals(self)
        # the device table, rounded once at upload (the host
        # preprocessing stays f32)
        self.feat_dtype = feat_dtype
        tab = torch.as_tensor(self.feat_np)
        if feat_dtype == "bfloat16":
            tab = tab.to(torch.bfloat16)
        self.feat_tab = tab.to(self.device)
        self.branches = self._build_branches()
        self.num_ensemble = len(self.branches)
        # PPR tables per mode: the host push unless asked for the device
        self._memory_bytes = ppr_mod.device_memory_bytes(self.device)
        auto_dev, _ = ppr_mod.plan_device_ppr(
            self.num_nodes, int(self._host_adj[TRAIN][1].size), self._memory_bytes)
        self.use_device_ppr = auto_dev if use_device_ppr is None else use_device_ppr
        self.tables: Dict[int, List[PPRTables]] = {}
        self.caches: Dict[int, list] = {}
        # the link task never caches (minibatch.py:213)
        self.nocache_modes = set() if self.task == "node" else {TRAIN, VALID, TEST}
        self._ppr_memo: Dict[tuple, tuple] = {}
        self.cache_budget_bytes = 2 << 30
        self.model_cfg = ModelConfig(
            dim_feat_smooth=self.dim_feat_smooth,
            dim_label_raw=self.num_classes,
            dim_label_smooth=self.dim_label_smooth,
            aggr=self.arch["aggr"],
            num_layers=self.arch["num_layers"],
            dim=self.arch["dim"],
            act=self.arch["act"],
            layer_norm=self.arch["layer_norm"],
            heads=int(self.arch["heads"]),
            residue=self.arch["residue"],
            pooling=self.arch["pooling"],
            loss=self.arch["loss"],
            num_cls_layers=self.arch["num_cls_layers"],
            feature_augment=tuple(self.arch["feature_augment"]),
            feature_augment_ops=self.arch["feature_augment_ops"],
            num_ensemble=self.num_ensemble,
            branch_sharing=bool(self.arch["branch_sharing"]),
            ensemble_act=self.arch["ensemble_act"],
            ensemble_dropout=self.params_train.get("ensemble_dropout", "none"),
            prediction_task=self.task,
            dropout=float(self.params_train["dropout"]),
            dropedge=float(self.params_train.get("dropedge", 0.0)),
            packed_adj=packed_adj,
            matmul_precision=matmul_precision or "float32",
            compute_dtype=compute_dtype,
        )
        # the steps' graphs (train/graphs.py), before a reload can drop
        # them
        self.step_graphs = StepGraphs(self.device,
                                      cuda_graphs and graphs_allowed(partition))
        self.model = DeepGNN(self.model_cfg)
        init_params(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()
        self.optimizer = make_optimizer(self.model.parameters(),
                                        float(self.params_train["lr"]))
        # resume from a previous run (reference retrain_dir
        # hyperparameter, main.py:128-132)
        if "retrain_dir" in self.params_train:
            self.load_run(self.params_train["retrain_dir"], optimizer=True)
        # train-metric batch subsampling (reference --eval_train_every);
        # 1 = use every batch
        self.eval_train_every = 1
        self._lookup: Dict[int, np.ndarray] = {}
        # --trace_dir: a torch.profiler trace of TRAIN epoch 1
        self.trace_dir: Optional[str] = None
        self.profiler = SubgraphProfiler(self.num_ensemble)
        print(f"[graphs] {self._graph_plan()}")

    def _graph_plan(self) -> str:
        """Which steps replay CUDA graphs, fixed by the configuration."""
        if self.partition != "none":
            from shadow_gnn_torch.parallel import multihost as mh
            where = f"partition {self.partition} over {mh.backend()}"
            if self.step_graphs.enabled:
                return (f"{where}: the TRAIN and eval steps replay CUDA graphs "
                        "with their collectives captured; the first-epoch "
                        "profile replays a graph")
            why = "on the CPU" if self.device.type != "cuda" else (
                "cuda_graphs=False" if mh.backend() == "nccl" else None)
            return f"{where}{f' ({why})' if why else ''}: every step runs eagerly"
        if self.step_graphs.enabled:
            steps = ("the TRAIN and eval steps replay CUDA graphs (negatives "
                     "drawn on the host once an epoch)" if self.task == "link" else
                     "the TRAIN and eval steps and the serving buckets replay "
                     "CUDA graphs")
            return (f"{steps}; a cached branch gathers and any other samples "
                    "and induces inside the graph; the first-epoch profile "
                    "replays a graph")
        why = "on the CPU" if self.device.type != "cuda" else "cuda_graphs=False"
        return f"off ({why}): every step runs eagerly"

    def load_run(self, run_dir: str, optimizer: bool = False):
        """Load the newest checkpoint of the run dir ``run_dir`` into the
        model (and into the optimizer, when ``optimizer`` and one was
        saved), and record the load in this run's dir."""
        pm, po = find_checkpoint(run_dir)
        po = po if optimizer else None
        model_sd, opt_sd = Logger.load_checkpoint(pm, po)
        self.model.load_state_dict(model_sd)
        if opt_sd is not None:
            # new state tensors: the TRAIN graphs read the old ones
            self.optimizer.load_state_dict(opt_sd)
            self.step_graphs.drop()
        self.logger.record_loaded_checkpoint(pm, po)

    # ------------------------------------------------------------------
    def _build_branches(self) -> List[Dict[str, Any]]:
        """Decoupled per-branch sampler dicts -> per-mode SamplerConfigs
        (``ppr_st`` reads its tables as ``ppr`` in VALID/TEST,
        minibatch.py:366-370; the link task never keeps target-target
        edges).  A ``khop`` branch's induction is sized here from the
        mode's degrees (``_plan_khop``); a PPR branch's when its tables
        are built (``_ensure_tables``)."""
        branches = []
        aug = tuple(self.arch["feature_augment"])
        for cfg_d in decouple_ensemble(self.sampler_cfg_train["configs"]):
            method = cfg_d["method"]
            if method == "full":
                # the reference's FULL train mode: each target its own
                # one-node block, nodeIID batching, for the backbones
                # whose propagation ran in the preprocessing
                if self.arch["aggr"] not in ADJ_FREE:
                    raise ValueError(
                        "full-graph TRAIN sampling requires an adjacency-free "
                        "model (mlp/sgc/sign); graph convs need a subgraph "
                        "sampler")
                cfg_d = dict(cfg_d, method="nodeIID")
                method = "nodeIID"
            if method not in ("ppr", "ppr_st", "khop", "nodeIID"):
                raise NotImplementedError(
                    f"sampler {method!r} is not ported yet "
                    "(ppr, ppr_st, khop, nodeIID)")
            common = dict(
                n_pad=default_n_pad(cfg_d, self.num_targets),
                num_targets=self.num_targets,
                depth=int(cfg_d.get("depth", 2)),
                budget=int(cfg_d.get("budget", 20)),
                k=int(cfg_d.get("k", 200)),
                alpha=float(cfg_d.get("alpha", 0.85)),
                epsilon=float(cfg_d.get("epsilon", 1e-5)),
                threshold=float(cfg_d.get("threshold", 0.0)),
                add_self_edge=bool(cfg_d.get("add_self_edge", False)),
                include_target_conn=(self.task == "node" and bool(
                    cfg_d.get("include_target_conn", False))),
                aug_feats=aug,
            )
            cfg_mode = {}
            for m in (TRAIN, VALID, TEST):
                plan = (self._plan_khop(m, common["n_pad"]) if method == "khop"
                        else {})
                method_m = "ppr" if method == "ppr_st" and m != TRAIN else method
                cfg_mode[m] = SamplerConfig(method=method_m, **common, **plan)
            branches.append({"raw": cfg_d, "cfg": cfg_mode})
        return branches

    def _plan_khop(self, mode: int, n_pad: int) -> dict:
        """Induction fields of a khop branch in ``mode``, by the JAX
        package's rules (``shadow_gnn_tpu/train/pipeline.py:354-387``):
        a power-law or over-budget undirected graph gets capped rows and
        a hub table; a graph of max degree up to 4096 within the budget
        exact rows; a directed over-budget one the pairwise search; a
        directed one with larger degrees candidate enumeration at an
        estimated cap.  The budget test is JAX's footprint formula
        (``plan_gather_bytes`` at the graph's ``row_block``)."""
        deg = np.diff(self._host_adj[mode][0]).astype(np.float64)
        max_deg = float(deg.max()) if deg.size else 1.0
        mean_deg = float(deg.mean()) if deg.size else 1.0
        over_budget = plan_gather_bytes(
            max(self.batch_size, 256), n_pad, int(max_deg),
            self.graph[mode].row_block) > PLAN_GATHER_BUDGET
        if self.undirected and (max_deg > 8 * mean_deg or over_budget):
            return dict(induction="rows",
                        deg_cap=bucket_cap(int(max(64.0, 8.0 * mean_deg))),
                        hub_slots=max(8, n_pad // 8))
        if max_deg <= 4096 and not over_budget:
            return dict(induction="rows", deg_cap=bucket_cap(int(max_deg)))
        if max_deg <= 4096:
            return dict(induction="search")
        # E[deg of a sampled node] is size-biased; x3 slack, the overflow
        # is reported every epoch
        biased = float((deg ** 2).sum() / max(deg.sum(), 1))
        est = min(max_deg, 3.0 * biased + 16.0)
        return dict(induction="cand", cand_cap=bucket_cap(int(n_pad * est)))

    # ------------------------------------------------------------------
    def _ppr_targets(self, mode: int) -> np.ndarray:
        """Nodes that need PPR rows (minibatch.py:383-389): the mode's
        node set, or every node for the link task (whose table rows are
        then node ids)."""
        if self.task == "node":
            return np.asarray(self.entity_set[mode], dtype=np.int64)
        return np.arange(self.num_nodes, dtype=np.int64)

    def _ensure_tables(self, mode: int):
        """PPR top-k tables of every branch for ``mode``, on the device,
        and the exact induction sizing of each branch's scope.  A
        ``ppr_st`` branch's tables are 2k wide (its race's pool) in every
        mode.  Modes of one adjacency and one target set (the link task's
        three) share one push, its tables and its plan."""
        if mode in self.tables:
            return
        # the ranks of a partition in turn, rank 0 first: it pushes (or
        # loads) and writes the PPR cache that the others then read
        turns = self.partition != "none"
        if turns:
            from shadow_gnn_torch.parallel import collectives as cc
            from shadow_gnn_torch.parallel import multihost as mh
            if mh.rank() > 0:
                cc.barrier()
        self._build_tables(mode)
        if turns and mh.rank() == 0:
            cc.barrier()

    def _build_tables(self, mode: int):
        tabs = []
        for i_br, br in enumerate(self.branches):
            cfg = br["cfg"][mode]
            if cfg.method not in ("ppr", "ppr_st"):
                tabs.append(None)
                continue
            k_tab = cfg.k * (2 if br["cfg"][TRAIN].method == "ppr_st" else 1)
            targets = self._ppr_targets(mode)
            memo_key = (i_br, k_tab, cfg.alpha, cfg.epsilon,
                        id(self._host_adj[mode][0]), hash(targets.tobytes()))
            if memo_key not in self._ppr_memo:
                neighs, scores = self._compute_ppr(mode, cfg, k_tab, targets)
                tab_n, tab_s = ppr_mod.ppr_topk_tables(neighs, scores, k_tab)
                deg = np.diff(self._host_adj[mode][0]).astype(np.int64)
                scope_deg = deg[np.clip(tab_n, 0, self.num_nodes - 1)] * (tab_n >= 0)
                fields = plan_ppr_induction(
                    scope_deg, deg[targets], n_pad=cfg.n_pad,
                    num_targets=self.num_targets, batch_size=self.batch_size,
                    undirected=self.undirected,
                    row_block=self.graph[mode].row_block)
                self._ppr_memo[memo_key] = (PPRTables(
                    torch.as_tensor(tab_n.astype(np.int64), device=self.device),
                    torch.as_tensor(tab_s, device=self.device)), fields)
            tab, fields = self._ppr_memo[memo_key]
            br["cfg"][mode] = dataclasses.replace(cfg, **fields)
            tabs.append(tab)
        self.tables[mode] = tabs

    def _compute_ppr(self, mode: int, cfg: SamplerConfig, k_tab: int,
                     targets: np.ndarray):
        """Load cached PPR lists for one mode, or push and cache them
        (the reference's file naming and reuse-larger-k contract).
        Without a data directory nothing is read or written."""
        indptr, indices = self._host_adj[mode]
        variant = "wval" if self.config_data.get("valedges_as_input", False) else ""
        fn = fs = None
        if self.dir_data:
            fn, fs = ppr_mod.find_ppr_cache(
                self.dir_data, self.name_data, self.is_transductive,
                MODE2STR[mode], cfg.alpha, cfg.epsilon, k_tab, variant=variant)
        if fn:
            cached = ppr_mod.read_ppr_cache(fn, fs, k_tab, cfg.alpha, cfg.epsilon)
            if cached is not None:
                nv, sv = cached
                return [nv[t] for t in targets], [sv[t] for t in targets]
        t0 = time.time()
        if self.use_device_ppr:
            # the block fitted to this mode's graph, which may hold more
            # edges than the TRAIN graph the constructor planned for
            _, batch = ppr_mod.plan_device_ppr(self.num_nodes, int(indices.size),
                                               self._memory_bytes)
            neighs, scores = ppr_mod.ppr_power_device(
                indptr, indices, targets, k_tab, cfg.alpha, batch=batch,
                device=self.device)
        else:
            neighs, scores = ppr_mod.ppr_push_host(indptr, indices, targets, k_tab,
                                                   cfg.alpha, cfg.epsilon)
        print(f"PPR precompute [{MODE2STR[mode]}] {targets.size} targets "
              f"in {time.time() - t0:.1f}s")
        if self.dir_data:
            fn, fs = ppr_mod.ppr_cache_paths(
                self.dir_data, self.name_data, self.is_transductive,
                MODE2STR[mode], cfg.alpha, cfg.epsilon, k_tab, variant=variant)
            try:
                ppr_mod.write_ppr_cache(fn, fs, self.num_nodes, targets, neighs,
                                        scores, k_tab, cfg.alpha, cfg.epsilon)
            except OSError:
                pass
        return neighs, scores

    # ------------------------------------------------------------------
    def _ensure_caches(self, mode: int):
        """Build each ppr branch's bit-packed subgraph cache for ``mode``
        (memory-gated; a branch over budget samples every request, and so
        does every other sampler)."""
        if mode in self.caches or mode in self.nocache_modes:
            self.caches.setdefault(mode, [None] * self.num_ensemble)
            return
        self._ensure_tables(mode)
        self.caches[mode] = [None] * self.num_ensemble
        ent = self._ppr_targets(mode)
        for i, br in enumerate(self.branches):
            cfg = br["cfg"][mode]
            if cfg.method != "ppr":
                continue
            est = cache_mod.estimate_bytes(ent.size, cfg.n_pad)
            if est > self.cache_budget_bytes:
                print(f"[cache] branch {i} mode {MODE2STR[mode]}: "
                      f"{est / 1e9:.1f}GB exceeds budget, resampling")
                continue
            graph, tabs = self.graph[mode], self.tables[mode][i]
            roots_all = torch.as_tensor(ent[:, None], device=self.device)
            rows_all = torch.arange(ent.size, device=self.device)[:, None]
            t0 = time.time()
            with torch.inference_mode():
                self.caches[mode][i] = cache_mod.build_cache(
                    lambda r, rw, cfg=cfg, graph=graph, tabs=tabs:
                        sample_subgraphs(cfg, graph, r, rw, tabs),
                    roots_all, rows_all, cfg)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            print(f"[cache] built branch {i} {MODE2STR[mode]}: {ent.size} "
                  f"subgraphs, {est / 1e6:.0f}MB, {time.time() - t0:.1f}s")
        if self.step_graphs.enabled:
            sampled = [f"{i} ({br['cfg'][mode].method})" for i, br in
                       enumerate(self.branches) if self.caches[mode][i] is None]
            print(f"[graphs] {MODE2STR[mode]}: " + (
                f"branch {', '.join(sampled)} uncached: sampled and induced "
                "inside its graphs" if sampled else
                "every branch cached: gathered inside its graphs"))

    def disable_cache(self, mode: int):
        """Serve ``mode`` by sampling every request (no cache): its cached
        steps' graphs are dropped, and its steps replay sampled ones from
        now on."""
        self.nocache_modes.add(mode)
        self.caches[mode] = [None] * self.num_ensemble
        self.step_graphs.drop(lambda key: key[1] == mode and "cached" in key[-1])

    def _cached(self, mode: int) -> bool:
        """Whether every branch of ``mode`` gathers from a built cache."""
        return "sampled" not in self._cache_sig(mode)

    def _cache_sig(self, mode: int) -> tuple:
        """Each branch's form in ``mode``'s steps, "cached" (gathered) or
        "sampled": the last part of a step key, so that a mode's cached
        and sampled forms never share a graph."""
        caches = self.caches.get(mode) or [None] * self.num_ensemble
        return tuple("sampled" if c is None else "cached" for c in caches)

    def _sample_branch_batches(self, mode: int, roots: torch.Tensor,
                               rows: torch.Tensor,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[List[SubgraphBatch], List[torch.Tensor]]:
        """Every branch's batch (gathered from its cache, or sampled and
        induced; the khop picks from ``generator``) and feature block."""
        batches, feats = [], []
        caches = self.caches.get(mode) or [None] * self.num_ensemble
        for i, br in enumerate(self.branches):
            cfg = br["cfg"][mode]
            if caches[i] is not None:
                batch = self._gather_branch(mode, i, rows[:, 0])
            else:
                batch = sample_subgraphs(cfg, self.graph[mode], roots, rows,
                                         self.tables[mode][i], generator)
            feats.append(self._features(batch))
            batches.append(batch)
        return batches, feats

    def _gather_branch(self, mode: int, i: int, rows: torch.Tensor) -> SubgraphBatch:
        """Branch i's batch of cache rows ``rows`` [B]; a model that reads
        the packed bits, or no block, gets no dense block."""
        return cache_mod.gather_batch(
            self.caches[mode][i], rows, self.branches[i]["cfg"][mode].n_pad,
            self.num_nodes, unpack=self.model_cfg.needs_dense_adj)

    def _features(self, batch: SubgraphBatch) -> torch.Tensor:
        """The batch's feature block in the compute dtype."""
        return self.feat_tab[torch.clamp(batch.nodes, 0, self.num_nodes - 1)].to(
            self.model_cfg.dtype)

    # ------------------------------------------------------------------
    # Training
    def _epoch_arrays(self, mode: int, ordered: bool = False):
        """Shuffled, percent-sampled, batch-padded root / row / label /
        weight arrays of one epoch (numpy).  Node task: roots [M, 1],
        rows their places in the node set.  Link task: the mode's
        positive edges and its negatives (TRAIN draws them,
        :meth:`_negative_sample`), roots [M, 2], which are also the table
        rows, labels 1.0 / 0.0 [M, 1].  ``ordered``: the drawn roots in
        entity-set order, so that a full set gives the same batches on
        every call."""
        b = self.batch_size
        pct = float(self.params_train["percent_per_epoch"][MODE2STR[mode]])
        if self.task == "node":
            ent = np.asarray(self.entity_set[mode])
            perm = self.rng_np.permutation(ent.size)
        else:
            es = self.entity_set[mode]
            pos = es["pos"]
            neg = es["neg"] if "neg" in es else self._negative_sample(pos.shape[0])
            ent = np.concatenate([pos, neg], 0)
            lab_all = np.repeat([1.0, 0.0], [pos.shape[0], neg.shape[0]])[:, None]
            perm = self.rng_np.permutation(ent.shape[0])
        if pct < 1.0:
            perm = perm[:int(np.ceil(pct * perm.size))]
        if ordered:
            perm = np.sort(perm)
        if self.task == "node":
            roots = ent[perm][:, None]                    # [M, 1]
            rows = perm[:, None]                          # table rows
            labels = self.label_np[ent[perm]]
        else:
            roots = rows = ent[perm]                      # [M, 2] node ids
            labels = lab_all[perm]
        m = roots.shape[0]
        nb = -(-m // b)
        pad = nb * b - m
        w = np.concatenate([np.ones(m, np.float32), np.zeros(pad, np.float32)])
        roots = np.concatenate([roots, np.repeat(roots[:1], pad, 0)])
        rows = np.concatenate([rows, np.repeat(rows[:1], pad, 0)])
        labels = np.concatenate([labels, np.repeat(labels[:1], pad, 0)])
        return nb, roots, rows, labels, w

    def _negative_sample(self, n: int) -> np.ndarray:
        """``n`` uniform edges [n, 2] that are neither self loops nor
        edges of the TRAIN graph (minibatch.py:287-293), by rejection
        against the sorted edge keys u * num_nodes + v, drawn from
        ``_neg_rng`` as the JAX Trainer draws them.  JAX computes the
        next epoch's sample ahead on a thread; with the same ``n`` on
        every call (only TRAIN draws) its stream is this sequence."""
        nn_ = self.num_nodes
        if self._neg_edge_keys is None:
            indptr, indices = self._host_adj[TRAIN]
            indptr = np.asarray(indptr, dtype=np.int64)
            src = np.repeat(np.arange(nn_, dtype=np.int64), np.diff(indptr))
            keys = src * nn_ + np.asarray(indices, dtype=np.int64)
            if np.any(np.diff(keys) < 0):
                keys = np.sort(keys)
            self._neg_edge_keys = keys
        keys = self._neg_edge_keys
        out, filled = None, 0
        while filled < n:
            # rejection is rare ((m + N) / N^2): a ~2% overshoot mostly
            # finishes in one pass
            size = (n - filled) + ((n - filled) >> 6) + 16
            cand = self._neg_rng.integers(0, nn_, size=(size, 2), dtype=np.int64)
            ck = cand[:, 0] * nn_ + cand[:, 1]
            at = np.searchsorted(keys, ck)
            bad = (cand[:, 0] == cand[:, 1]) | (
                (at < keys.size) & (keys[np.minimum(at, keys.size - 1)] == ck))
            good = cand[~bad]
            if out is None:
                if good.shape[0] >= n:
                    return good[:n]
                out = np.empty((n, 2), np.int64)
            take = min(n - filled, good.shape[0])
            out[filled:filled + take] = good[:take]
            filled += take
        return out

    def _forward_loss(self, batches: List[SubgraphBatch],
                      feats: List[torch.Tensor], labels: torch.Tensor,
                      w: torch.Tensor, rng: Optional[EpochRNG] = None,
                      mode_train: bool = True):
        """(loss, logits) of one batch; in training mode with the
        epoch's dropout generator and one fresh dropedge seed.
        ``mode_train``: the batch is of the TRAIN node set (its label
        inputs are zeroed at the targets)."""
        gen, seed = None, 0
        if self.model.training and rng is not None:
            gen = rng.dropout
            if self.model_cfg.dropedge > 0.0:
                seed = rng.dropedge_seed()
        logits, _ = self.model(batches, feats, gen, seed, mode_train)
        return weighted_loss_fn(self.model_cfg, logits, labels, w), logits

    def _train_step(self, batches, feats, labels, w, rng: EpochRNG):
        """Forward, backward, clip and Adam update of one TRAIN batch,
        eagerly: the reference the static step (:meth:`_static_train`)
        is held to."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, logits = self._forward_loss(batches, feats, labels, w, rng)
        loss.backward()
        clip_grad_global_norm_(self.model.parameters(), CLIP_NORM)
        self.optimizer.step()
        return loss.detach(), predict_fn(self.model_cfg, logits.detach())

    @torch.no_grad()
    def _eval_step(self, batches, feats, labels, w, mode_train: bool = False):
        """One evaluation batch, eagerly (the reference of
        :meth:`_static_eval`)."""
        loss, logits = self._forward_loss(batches, feats, labels, w,
                                          mode_train=mode_train)
        return loss, predict_fn(self.model_cfg, logits)

    # The steps as functions of static buffers (``buf``: roots [B, T] and
    # PPR table rows [B, T], labels, weights, the dropedge seed), captured
    # in CUDA graphs on a graphed Trainer (train/graphs.py).  Each branch
    # gathers from its cache, or samples and induces with the picks and
    # uniforms of ``sampler``
    def _static_batches(self, mode: int, buf, sampler):
        with torch.no_grad(), span("sgnn.stage.sample"):
            return self._sample_branch_batches(mode, buf["roots"], buf["rows"],
                                               sampler)

    def _static_train(self, mode: int, buf, generator, sampler):
        """The TRAIN step: every branch's batch, forward (dropout from
        ``generator``, dropedge from ``buf["seed"]``), backward, clip and
        Adam.  Returns (loss, predictions, the gradients, the induction
        overflow)."""
        batches, feats = self._static_batches(mode, buf, sampler)
        self.optimizer.zero_grad(set_to_none=True)
        with span("sgnn.stage.forward"):
            logits, _ = self.model(batches, feats, generator, buf["seed"], True)
            loss = weighted_loss_fn(self.model_cfg, logits, buf["labels"], buf["w"])
        with span("sgnn.stage.backward"):
            loss.backward()
        with span("sgnn.stage.optimizer"):
            clip_grad_global_norm_(self.model.parameters(), CLIP_NORM)
            self.optimizer.step()
        # the gradients stay with the graph: a replay writes them
        return (loss.detach(), predict_fn(self.model_cfg, logits.detach()),
                [p.grad for p in self.model.parameters()],
                total_overflow(batches, self.device))

    @torch.no_grad()
    def _static_eval(self, mode: int, buf, mode_train: bool, sampler):
        """The evaluation step: (loss, probabilities, per-branch
        embeddings, the induction overflow)."""
        batches, feats = self._static_batches(mode, buf, sampler)
        with span("sgnn.stage.forward"):
            logits, embs = self.model(batches, feats, mode_train=mode_train)
            loss = weighted_loss_fn(self.model_cfg, logits, buf["labels"], buf["w"])
        return (loss, predict_fn(self.model_cfg, logits), embs,
                total_overflow(batches, self.device))

    @torch.no_grad()
    def _static_serve(self, mode: int, buf, sampler):
        """A request bucket: (probabilities [cap, C], embeddings
        [branches, cap, dim])."""
        batches, feats = self._static_batches(mode, buf, sampler)
        with span("sgnn.stage.forward"):
            logits, embs = self.model(batches, feats)
        return predict_fn(self.model_cfg, logits), torch.stack(embs)

    def _graph_deps(self, mode: int, train: bool) -> tuple:
        """The objects whose tensors a step of ``mode`` reads."""
        deps = (self.model, self.feat_tab, self.graph[mode],
                *(self.tables.get(mode) or ()),
                *(self.caches.get(mode) or ()))
        return deps + (self.optimizer, self.optimizer.state) if train else deps

    def _graph_train_step(self, mode: int, roots, rows, labels, w, rng: EpochRNG,
                          generator: Optional[torch.Generator],
                          sampler: Optional[torch.Generator]):
        """One TRAIN step (``roots`` / ``rows`` [B, T]): its inputs and one
        fresh dropedge seed written into the static buffers, then
        :meth:`_static_train`, replayed from a CUDA graph on a graphed
        Trainer.  ``generator`` / ``sampler``: the pass's dropout and
        sampler generators (``StepGraphs.dropout`` / ``sampling``).
        Returns (loss, predictions), copied out, and the overflow."""
        seed = rng.dropedge_seed() if self.model_cfg.dropedge > 0.0 else 0
        key = ("train", mode, roots.shape[0], self._cache_sig(mode))
        buf = self.step_graphs.inputs(key, roots=roots, rows=rows, labels=labels,
                                      w=w, seed=seed)
        loss, pred, _, ovf = self.step_graphs.run(
            key, self._graph_deps(mode, True),
            lambda: self._static_train(mode, buf, generator, sampler))
        return loss.clone(), pred.clone(), ovf.clone()

    def _graph_eval_step(self, mode: int, roots, rows, labels, w, mode_train: bool,
                         sampler: Optional[torch.Generator]):
        """One evaluation step through :meth:`_static_eval` (replayed on a
        graphed Trainer): (loss, probabilities, per-branch embeddings, the
        overflow), copied out."""
        key = ("eval", mode, mode_train, roots.shape[0], self._cache_sig(mode))
        buf = self.step_graphs.inputs(key, roots=roots, rows=rows, labels=labels, w=w)
        loss, probs, embs, ovf = self.step_graphs.run(
            key, self._graph_deps(mode, False),
            lambda: self._static_eval(mode, buf, mode_train, sampler))
        return loss.clone(), probs.clone(), [e.clone() for e in embs], ovf.clone()

    def _batches(self, mode: int, nb: int, roots, rows,
                 generator: Optional[torch.Generator]):
        """Yield (row slice, branch batches, feature blocks) of each of
        ``nb`` batches of ``mode``, eagerly, one batch at a time (the cost
        count, ``train/complexity.py``)."""
        b, dev = self.batch_size, self.device
        roots_d = torch.as_tensor(roots.astype(np.int64), device=dev)
        rows_d = torch.as_tensor(rows.astype(np.int64), device=dev)
        for i in range(nb):
            sl = slice(i * b, (i + 1) * b)
            with torch.no_grad():
                batches, feats = self._sample_branch_batches(
                    mode, roots_d[sl], rows_d[sl], generator)
            yield sl, batches, feats

    def _epoch_tensors(self, roots, rows, labels, w):
        """The epoch arrays on the device: roots and rows [M, T] int64,
        labels (f32 where they are 2-D, else int64) and weights."""
        dev = self.device
        return (torch.as_tensor(roots.astype(np.int64), device=dev),
                torch.as_tensor(rows.astype(np.int64), device=dev),
                torch.as_tensor(labels.astype(np.float32 if labels.ndim > 1
                                              else np.int64), device=dev),
                torch.as_tensor(w, device=dev))

    def _run_batches(self, mode: int, train: bool, nb: int, roots, rows,
                     labels, w, rng: EpochRNG):
        """One pass over ``nb`` batches, each through the step graphs.
        Returns per-batch losses [nb], predictions [nb * B, C] (numpy)
        and the induction overflow, summed on the device (a 0-d int64
        tensor)."""
        b, sg = self.batch_size, self.step_graphs
        losses, preds = [], []
        with contextlib.ExitStack() as lent:
            with span("sgnn.epoch.prepare"):
                roots_d, rows_d, lab_d, w_d = self._epoch_tensors(roots, rows, labels, w)
                self.model.train(train)
                ovf = no_overflow(self.device)
                gen = lent.enter_context(sg.dropout(rng.dropout))
                sampler = lent.enter_context(sg.sampling(rng.sample))
            with span("sgnn.epoch.steps"):
                for i in range(nb):
                    sl = slice(i * b, (i + 1) * b)
                    with span("sgnn.step", step=i):
                        if train:
                            loss, pred, o = self._graph_train_step(
                                mode, roots_d[sl], rows_d[sl], lab_d[sl], w_d[sl], rng,
                                gen, sampler)
                        else:
                            loss, pred, _, o = self._graph_eval_step(
                                mode, roots_d[sl], rows_d[sl], lab_d[sl], w_d[sl],
                                mode == TRAIN, sampler)
                        losses.append(loss)
                        preds.append(pred)
                        ovf += o
        self.model.eval()
        with span("sgnn.epoch.readback"):
            return (torch.stack(losses).cpu().numpy(), torch.cat(preds).cpu().numpy(),
                    ovf)

    # ------------------------------------------------------------------
    # Partitioned epochs (parallel/)
    def _partition_step(self, mode: int, train: bool):
        """The step of this Trainer's partition for ``mode``, built once:
        ``dp`` trains on the replicated state and evaluates through the
        ``feat`` form (JAX's multi-process rule), ``feat`` and ``edge``
        train and evaluate their own."""
        key = (mode, train)
        if key not in self._partition_fns:
            if self.partition == "dp" and train:
                from shadow_gnn_torch.parallel.dp import make_dp_train_step
                step = make_dp_train_step(self, mode)
            elif self.partition in ("dp", "feat"):
                from shadow_gnn_torch.parallel.partition import make_sharded_train_step
                step = make_sharded_train_step(self, mode, train)[0]
            else:
                from shadow_gnn_torch.parallel.edgepart import make_edgepart_train_step
                step = make_edgepart_train_step(self, mode, train=train)[0]
            self._partition_fns[key] = step
        return self._partition_fns[key]

    def _run_partition(self, mode: int, train: bool, nb: int, roots, rows, labels,
                       w, seed: int):
        """One partitioned pass over ``nb`` batches of the epoch arrays
        (every rank passes the same): this rank runs its contiguous share
        of each batch's columns through the partition's static step
        (``parallel/partition.py:make_step``), replayed from a CUDA graph
        on a graphed Trainer, under the pass's lent dropout and sampler
        generators.  The key ``("ptrain" | "peval", mode, columns a rank,
        the branches' forms)`` is the same on every rank.  Returns the
        global per-batch losses [nb], the global predictions [nb * B, C]
        (numpy, rank order) and the summed overflow (a 0-d int64 tensor);
        a TRAIN pass then checks that the parameters are bit-equal across
        ranks."""
        from shadow_gnn_torch.parallel import multihost as mh
        sg = self.step_graphs
        b, dev = self.batch_size, self.device
        losses, preds = [], []
        with contextlib.ExitStack() as lent:
            with span("sgnn.epoch.prepare"):
                step = self._partition_step(mode, train)
                sl = mh.process_slice(b)
                rng = EpochRNG.from_seed(rank_seed(seed, mh.rank()), dev)
                cols = np.concatenate([np.arange(i * b + sl.start, i * b + sl.stop)
                                       for i in range(nb)])
                per = sl.stop - sl.start
                roots_d, rows_d, lab_d, w_d = self._epoch_tensors(
                    roots[cols], rows[cols], labels[cols], w[cols])
                key = ("ptrain" if train else "peval", mode, per, step.sig())
                deps = self._graph_deps(mode, train) + step.deps
                draw = train and self.model_cfg.dropedge > 0.0
                self.model.train(train)
                ovf = no_overflow(dev)
                gen = lent.enter_context(sg.dropout(rng.dropout))
                sampler = lent.enter_context(sg.sampling(rng.sample))
            with span("sgnn.epoch.steps"):
                for i in range(nb):
                    p = slice(i * per, (i + 1) * per)
                    with span("sgnn.step", step=i):
                        extra = ({"seed": rng.dropedge_seed() if draw else 0}
                                 if train else {})
                        buf = sg.inputs(key, roots=roots_d[p], rows=rows_d[p],
                                        labels=lab_d[p], w=w_d[p], **extra)
                        out = sg.run(key, deps, lambda: step(buf, gen, sampler))
                        losses.append(out[0].clone())
                        preds.append(out[1].clone())
                        ovf += out[2]
        self.model.eval()
        with span("sgnn.epoch.readback"):
            if train:
                self.partition_train_dispatches += 1
                self.check_replicas()
            return (torch.stack(losses).cpu().numpy(), torch.cat(preds).cpu().numpy(),
                    ovf)

    def param_checksum(self) -> torch.Tensor:
        """int64 [2]: the sum and an index-weighted sum of the bits of
        every parameter (as int32 words); equal on ranks whose
        parameters are equal bit for bit."""
        with torch.no_grad():
            words = torch.cat([p.detach().float().reshape(-1)
                               for p in self.model.parameters()]).view(torch.int32)
            words = words.to(torch.int64)
            wt = torch.arange(words.numel(), device=words.device) % 65521 + 1
            return torch.stack([words.sum(), (words * wt).sum()])

    def check_replicas(self):
        """Raise unless every rank's parameters equal rank 0's bit for
        bit (an all-gathered checksum)."""
        from shadow_gnn_torch.parallel import collectives as cc
        sums = cc.all_gather(self.param_checksum()).cpu()
        if not bool((sums == sums[0]).all()):
            raise RuntimeError(f"the ranks' parameters differ after a TRAIN epoch: "
                               f"checksums {sums.tolist()}")

    def run_epoch(self, epoch: int, mode: int, status: str = "running"):
        """One TRAIN (with updates) or evaluation pass over the mode's
        node set; logs and returns its stats.  TRAIN epoch 1 runs under
        ``--trace_dir``'s profiler, when one is set."""
        train = mode == TRAIN and status == "running"
        traced = train and epoch == 1
        with _epoch_trace(self.trace_dir if traced else None, self.device), \
                span("sgnn.epoch", epoch=epoch, mode=mode):
            with span("sgnn.epoch.prepare"):
                self._ensure_tables(mode)
                self._ensure_caches(mode)
                if epoch == 0 and status == "running" and self.profiler.enabled:
                    # the subgraph statistics of the first epoch, then no more
                    self._profile_epoch(mode)
                    print(f"[profiler] {MODE2STR[mode]} subgraph stats:")
                    self.profiler.print_summary()
                    self.profiler.clear_metrics()
                    self.profiler.enabled = False
                nb, roots, rows, labels_np, w_np = self._epoch_arrays(mode)
                seed = int(self.rng_np.integers(1 << 31))
            t0 = time.time()
            if self.partition != "none":
                losses, preds, ovf = self._run_partition(mode, train, nb, roots, rows,
                                                         labels_np, w_np, seed)
            else:
                losses, preds, ovf = self._run_batches(
                    mode, train, nb, roots, rows, labels_np, w_np,
                    EpochRNG.from_seed(seed, self.device))
            t1 = time.time()
            with span("sgnn.epoch.readback"):
                ovf = int(ovf)                  # the epoch's one read of it
            if ovf > 0:
                print(f"[WARN] induction candidate overflow: {ovf} edges "
                      f"dropped this epoch (raise cand_cap)")
            with span("sgnn.epoch.metrics"):
                return self._epoch_stats(epoch, mode, status, train, losses, preds,
                                         labels_np, w_np, t1 - t0)

    def _epoch_stats(self, epoch: int, mode: int, status: str, train: bool, losses,
                     preds, labels_np, w_np, time_s: float):
        """The epoch's metrics on the host over its valid rows (TRAIN's
        optionally over every Nth batch only: the reference's PERIOD_LOG
        subsampling), logged and returned."""
        valid = w_np > 0
        if train and self.eval_train_every > 1:
            sel = np.arange(losses.size) % self.eval_train_every == 0
            losses = losses[sel]
            valid = valid & np.repeat(sel, self.batch_size)
        y_pred = preds[valid]
        y_true = labels_np[valid]
        if y_true.ndim == 1:
            y_true = np.eye(self.num_classes, dtype=np.float32)[
                y_true.astype(np.int64)]
        stats = {"loss": float(losses.mean())}
        stats.update(self.metrics.calc(y_true, y_pred))
        self.logger.log_epoch(mode, epoch, stats, status=status, time_s=time_s)
        return stats

    @torch.no_grad()
    def _static_profile(self, mode: int, buf, sampler):
        """The first-epoch profile's step: every branch's batch of
        ``buf``'s roots and rows, its ``batch_stats`` over the rows whose
        weight is set added into ``buf["hops"]`` [branches, DIM_1HOT_HOP]
        (f64) and ``buf["counts"]`` [branches, 3] (nodes, edges,
        subgraphs; int64), the static accumulators of the pass."""
        batches, _ = self._static_batches(mode, buf, sampler)
        valid = buf["w"] > 0
        for i, batch in enumerate(batches):
            hops, nodes, edges, n = batch_stats(batch, valid)
            buf["hops"][i] += hops
            buf["counts"][i] += torch.stack([nodes, edges, n])
        return ()

    def _profile_epoch(self, mode: int):
        """Feed the profiler every batch of one epoch of ``mode``, sampled
        as the epoch would be (its own draw from ``rng_np``, as JAX's
        pass draws one; the khop picks from a generator seeded with 0,
        lent to the step), through :meth:`_static_profile` (replayed from a
        CUDA graph on a graphed Trainer), the padding rows left out.  The
        accumulators are read once, after the pass.  No model runs."""
        nb, roots, rows, labels, w = self._epoch_arrays(mode)
        roots_d, rows_d, _, w_d = self._epoch_tensors(roots, rows, labels, w)
        e, b, sg = self.num_ensemble, self.batch_size, self.step_graphs
        key = ("profile", mode, b, self._cache_sig(mode))
        zero = {"hops": torch.zeros(e, DIM_1HOT_HOP, dtype=torch.float64),
                "counts": torch.zeros(e, 3, dtype=torch.int64)}
        gen = torch.Generator(device=self.device).manual_seed(0)
        with sg.sampling(gen) as sampler:
            for i in range(nb):
                sl = slice(i * b, (i + 1) * b)
                with span("sgnn.step", step=i):
                    buf = sg.inputs(key, roots=roots_d[sl], rows=rows_d[sl], w=w_d[sl],
                                    **(zero if i == 0 else {}))
                    sg.run(key, self._graph_deps(mode, False),
                           lambda: self._static_profile(mode, buf, sampler))
        hops, counts = buf["hops"].cpu().numpy(), buf["counts"].cpu().numpy()
        for i in range(e):
            self.profiler.update_stats(i, hops[i], *counts[i].tolist())

    def train(self, log_test_convergence: int = -1):
        """``end`` epochs of TRAIN then VALID (TEST every
        ``log_test_convergence`` epochs), best-model selection over
        VALID, then the final TRAIN / VALID / TEST passes with the best
        model.  Returns the final stats per mode."""
        max_epoch = int(self.params_train["end"])
        for e in range(max_epoch):
            self.run_epoch(e, TRAIN)
            self.run_epoch(e, VALID)
            if log_test_convergence > 0 and e % log_test_convergence == 0:
                self.run_epoch(e, TEST)
            self.logger.update_best_model(e, self.model.state_dict(),
                                          self.optimizer.state_dict())
        self.logger.validate_result()
        print("=" * 22 + "\nOptimization Finished!\n" + "=" * 22)
        best_model, _ = self.logger.restore_model()
        if best_model is not None:
            self.model.load_state_dict(best_model)
        for md in (TRAIN, VALID, TEST):
            stats = self.run_epoch(max_epoch, md, status="final")
            self.logger.log_final(md, stats)
        return self.logger.final_stats

    def inference(self, modes=(VALID, TEST)) -> str:
        """One evaluation pass of each mode with the loaded model,
        sampling every batch inside its step graphs (reference
        main.py:204-211); logs the final stats and returns the ``FINAL
        SUMMARY:`` line."""
        for md in modes:
            self.disable_cache(md)
            stats = self.run_epoch(0, md, status="final")
            self.logger.log_final(md, stats)
        return self.logger.final_summary()

    # ------------------------------------------------------------------
    # Full-graph passes (the post-processing's inputs)
    def _node_task_only(self, what: str):
        if self.task != "node":
            raise NotImplementedError(
                f"{what} serves the node task only (the JAX Trainer "
                "asserts task == 'node'); a link model is evaluated by "
                "run_epoch / inference")

    def _full_pass(self, modes, embed: bool) -> List[torch.Tensor]:
        """Every node of each mode's node set through the eval step (a
        branch's cache where one is built, else sampling), in node-set
        order, the khop picks from a generator seeded with
        ``SERVE_SEED``: two calls give the same matrices.  Returns, on the
        device, [probabilities [num_nodes, C]] or, with ``embed``, the
        per-branch embeddings [num_nodes, dim]; rows no mode covers are
        zero."""
        self._node_task_only("embed_full" if embed else "predict_full")
        if embed:
            out = [torch.zeros(self.num_nodes, self.model_cfg.dim, device=self.device)
                   for _ in range(self.num_ensemble)]
        else:
            out = [torch.zeros(self.num_nodes, self.num_classes, device=self.device)]
        self.model.eval()
        for md in modes:
            self._ensure_tables(md)
            nb, roots, rows, labels, w = self._epoch_arrays(md, ordered=True)
            gen = torch.Generator(device=self.device).manual_seed(SERVE_SEED)
            n_valid = int((w > 0).sum())           # the padding rows come last
            ids = torch.as_tensor(roots[:n_valid, 0].astype(np.int64),
                                  device=self.device)
            roots_d, rows_d, lab_d, w_d = self._epoch_tensors(roots, rows, labels, w)
            b = self.batch_size
            with torch.inference_mode(), self.step_graphs.sampling(gen) as sampler:
                for i in range(nb):
                    sl = slice(i * b, (i + 1) * b)
                    _, probs, embs, _ = self._graph_eval_step(
                        md, roots_d[sl], rows_d[sl], lab_d[sl], w_d[sl], md == TRAIN,
                        sampler)
                    res = embs if embed else [probs]
                    hi = min(sl.stop, n_valid)
                    for o, r in zip(out, res):
                        o[ids[sl.start:hi]] = r[:hi - sl.start]
        return out

    def predict_full(self, modes=(TRAIN, VALID, TEST)) -> np.ndarray:
        """Full-graph prediction matrix pred_mat[node id] = probabilities
        [num_nodes, C] f32, for Correct & Smooth (reference
        main.py:237-249)."""
        return self._full_pass(modes, embed=False)[0].cpu().numpy()

    def embed_full(self, modes=(TRAIN, VALID, TEST)) -> List[np.ndarray]:
        """Per-branch embedding matrices emb[node id] [num_nodes, dim]
        f32, for the subgraph post-ensemble (reference main.py:270-282)."""
        return [e.cpu().numpy() for e in self._full_pass(modes, embed=True)]

    # ------------------------------------------------------------------
    # Online serving
    def prepare_serving(self, mode: int = TEST) -> Dict[str, float]:
        """Build the mode's PPR tables and subgraph cache before the
        first request (otherwise the first request builds them).
        Returns the seconds each took."""
        t0 = time.perf_counter()
        self._ensure_tables(mode)
        t1 = time.perf_counter()
        self._ensure_caches(mode)
        return {"ppr_s": t1 - t0, "cache_s": time.perf_counter() - t1}

    def _serve_lookup(self, mode: int) -> np.ndarray:
        """id -> PPR-table-row map for the mode's target set (-1 = not
        covered)."""
        if mode not in self._lookup:
            lk = np.full(self.num_nodes, -1, dtype=np.int64)
            tgt = self._ppr_targets(mode)
            lk[tgt] = np.arange(tgt.size)
            self._lookup[mode] = lk
        return self._lookup[mode]

    def _serve_batch(self, ids, mode: int, what: str):
        self._node_task_only(what)
        ids = np.asarray(ids, dtype=np.int64).ravel()
        if ids.size == 0:
            raise ValueError("empty id batch")
        self._ensure_tables(mode)
        self._ensure_caches(mode)
        rows = self._serve_lookup(mode)[ids]
        if (rows < 0).any():
            raise ValueError(
                f"node ids not covered by mode-{mode} PPR tables "
                f"(first few: {ids[rows < 0][:5].tolist()}); include them "
                "in the mode's node_set before building the trainer")
        n = ids.size
        # pad to the shared request buckets of the JAX package
        cap = 8 if n <= 8 else bucket_cap(n)
        if cap > n:
            ids = np.concatenate([ids, np.full(cap - n, ids[0])])
            rows = np.concatenate([rows, np.full(cap - n, rows[0])])
        # the bucket's serve step (its graph); a sampled branch's picks
        # from a generator seeded with SERVE_SEED on every request
        key = ("serve", mode, cap, self._cache_sig(mode))
        buf = self.step_graphs.inputs(key, roots=torch.from_numpy(ids[:, None]),
                                      rows=torch.from_numpy(rows[:, None]))
        gen = torch.Generator(device=self.device).manual_seed(SERVE_SEED)
        with self.step_graphs.sampling(gen) as sampler:
            probs, embs = self.step_graphs.run(
                key, self._graph_deps(mode, False),
                lambda: self._static_serve(mode, buf, sampler))
        return probs[:n].cpu().numpy(), embs[:, :n].cpu().numpy()

    def predict_nodes(self, ids, mode: int = TEST) -> np.ndarray:
        """Point-query serving: class probabilities [len(ids), C] for node
        ids of the mode's node set (PPR-row gather -> cached subgraph ->
        forward)."""
        with span("sgnn.request", ids=int(np.size(ids))):
            return self._serve_batch(ids, mode, "predict_nodes")[0]

    def embed_nodes(self, ids, mode: int = TEST) -> List[np.ndarray]:
        """Point-query embeddings: per-ensemble-branch [len(ids), dim]."""
        with span("sgnn.request", ids=int(np.size(ids))):
            embs = self._serve_batch(ids, mode, "embed_nodes")[1]
        return [embs[i] for i in range(self.num_ensemble)]
