"""Training and serving pipeline: data -> PPR tables -> subgraph cache
-> model -> loops.

The port of the JAX package's ``train/pipeline.py`` Trainer for the
node and link tasks: per-mode device graphs, per-branch samplers
(``ppr``, ``ppr_st``, ``khop``, ``nodeIID``) and their induction plans,
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
* everything runs eagerly on ``device`` (default ``"cuda"``; CUDA
  absent raises), one batch at a time: there are no epoch-scan, chunk,
  partition or profiler programs;
* dropout masks come from a ``torch.Generator`` on the device and
  dropedge seeds from one on the host, both seeded per epoch from
  ``rng_np``; the masks themselves differ from JAX's.  ``rng_np`` is
  consumed in the JAX Trainer's order (a permutation, then one seed,
  per epoch), so epoch permutations match a JAX run whose first-epoch
  subgraph profile is off (that profile draws one more permutation and
  is not ported);
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
  never by a global flag; ``matmul_precision="tensorfloat32"`` is not
  ported.  A bf16 feature table is widened to the compute dtype at the
  gather (exact), so an f32 model sees the rounded features in f32.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
from shadow_gnn_torch.data.graph import DeviceGraph, RawGraph, is_undirected
from shadow_gnn_torch.nn.layers import init_params
from shadow_gnn_torch.nn.model import DeepGNN, ModelConfig, predict_fn, row_losses
from shadow_gnn_torch.sampling import cache as cache_mod
from shadow_gnn_torch.sampling import ppr as ppr_mod
from shadow_gnn_torch.sampling.batch import SamplerConfig, SubgraphBatch, default_n_pad
from shadow_gnn_torch.sampling.induction import (PLAN_GATHER_BUDGET, bucket_cap,
                                                 plan_gather_bytes,
                                                 plan_ppr_induction)
from shadow_gnn_torch.sampling.samplers import PPRTables, sample_subgraphs
from shadow_gnn_torch.train.config import DATA_METRIC, decouple_ensemble
from shadow_gnn_torch.train.logger import Logger, find_checkpoint
from shadow_gnn_torch.train.metrics import Metrics

CLIP_NORM = 5.0                 # reference models.py:223
SERVE_SEED = 0                  # the khop picks of every request


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return dev


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
    gradients first, by :func:`clip_grad_global_norm_`)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


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
                 compute_dtype: str = "float32", feat_dtype: str = "float32"):
        """``metrics`` defaults to the dataset's metric (DATA_METRIC,
        else accuracy) and ``logger`` to one that writes no files.
        ``matmul_precision`` (None = "float32", or "bfloat16"),
        ``compute_dtype`` and ``feat_dtype`` ("float32" or "bfloat16") are
        the JAX Trainer's arguments of those names; the model checks the
        first two."""
        if feat_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported feat_dtype {feat_dtype!r}")
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

    def load_run(self, run_dir: str, optimizer: bool = False):
        """Load the newest checkpoint of the run dir ``run_dir`` into the
        model (and into the optimizer, when ``optimizer`` and one was
        saved), and record the load in this run's dir."""
        pm, po = find_checkpoint(run_dir)
        po = po if optimizer else None
        model_sd, opt_sd = Logger.load_checkpoint(pm, po)
        self.model.load_state_dict(model_sd)
        if opt_sd is not None:
            self.optimizer.load_state_dict(opt_sd)
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

    def disable_cache(self, mode: int):
        """Serve ``mode`` by sampling every request (no cache)."""
        self.nocache_modes.add(mode)
        self.caches[mode] = [None] * self.num_ensemble

    def _sample_branch_batches(self, mode: int, roots: torch.Tensor,
                               rows: torch.Tensor,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[List[SubgraphBatch], List[torch.Tensor]]:
        """Every branch's batch (gathered from its cache, or sampled and
        induced; the khop picks from ``generator``) and feature block."""
        batches, feats = [], []
        for i, br in enumerate(self.branches):
            cfg = br["cfg"][mode]
            cache = self.caches.get(mode, [None] * self.num_ensemble)[i]
            if cache is not None:
                # a model that reads the packed bits gets no dense block
                batch = cache_mod.gather_batch(
                    cache, rows[:, 0], cfg.n_pad, self.num_nodes,
                    unpack=not self.model_cfg.reads_packed_bits)
            else:
                batch = sample_subgraphs(cfg, self.graph[mode], roots, rows,
                                         self.tables[mode][i], generator)
            feats.append(self.feat_tab[torch.clamp(
                batch.nodes, 0, self.num_nodes - 1)].to(self.model_cfg.dtype))
            batches.append(batch)
        return batches, feats

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
        """Forward, backward, clip and Adam update of one TRAIN batch."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, logits = self._forward_loss(batches, feats, labels, w, rng)
        loss.backward()
        clip_grad_global_norm_(self.model.parameters(), CLIP_NORM)
        self.optimizer.step()
        return loss.detach(), predict_fn(self.model_cfg, logits.detach())

    @torch.no_grad()
    def _eval_step(self, batches, feats, labels, w, mode_train: bool = False):
        loss, logits = self._forward_loss(batches, feats, labels, w,
                                          mode_train=mode_train)
        return loss, predict_fn(self.model_cfg, logits)

    def _batches(self, mode: int, nb: int, roots, rows,
                 generator: Optional[torch.Generator]):
        """Yield (row slice, branch batches, feature blocks) of each of
        ``nb`` batches of ``mode``, eagerly, one batch at a time."""
        b, dev = self.batch_size, self.device
        roots_d = torch.as_tensor(roots.astype(np.int64), device=dev)
        rows_d = torch.as_tensor(rows.astype(np.int64), device=dev)
        for i in range(nb):
            sl = slice(i * b, (i + 1) * b)
            with torch.no_grad():
                batches, feats = self._sample_branch_batches(
                    mode, roots_d[sl], rows_d[sl], generator)
            yield sl, batches, feats

    def _run_batches(self, mode: int, train: bool, nb: int, roots, rows,
                     labels, w, rng: EpochRNG):
        """One pass over ``nb`` batches.  Returns per-batch losses [nb],
        predictions [nb * B, C] (numpy) and the induction overflow."""
        dev = self.device
        lab_d = torch.as_tensor(labels.astype(np.float32 if labels.ndim > 1
                                              else np.int64), device=dev)
        w_d = torch.as_tensor(w, device=dev)
        self.model.train(train)
        losses, preds, ovf = [], [], 0
        for sl, batches, feats in self._batches(mode, nb, roots, rows, rng.sample):
            ovf += sum(bt.overflow for bt in batches)
            if train:
                loss, pred = self._train_step(batches, feats, lab_d[sl], w_d[sl], rng)
            else:
                loss, pred = self._eval_step(batches, feats, lab_d[sl], w_d[sl],
                                             mode_train=mode == TRAIN)
            losses.append(loss)
            preds.append(pred)
        self.model.eval()
        return (torch.stack(losses).cpu().numpy(), torch.cat(preds).cpu().numpy(),
                ovf)

    def run_epoch(self, epoch: int, mode: int, status: str = "running"):
        """One TRAIN (with updates) or evaluation pass over the mode's
        node set; logs and returns its stats."""
        self._ensure_tables(mode)
        self._ensure_caches(mode)
        train = mode == TRAIN and status == "running"
        nb, roots, rows, labels_np, w_np = self._epoch_arrays(mode)
        rng = EpochRNG.from_seed(int(self.rng_np.integers(1 << 31)), self.device)
        t0 = time.time()
        losses, preds, ovf = self._run_batches(mode, train, nb, roots, rows,
                                               labels_np, w_np, rng)
        t1 = time.time()
        if ovf > 0:
            print(f"[WARN] induction candidate overflow: {ovf} edges "
                  f"dropped this epoch (raise cand_cap)")
        # metrics on the host over valid rows; TRAIN metrics optionally
        # use only every Nth batch (reference PERIOD_LOG subsampling)
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
        self.logger.log_epoch(mode, epoch, stats, status=status, time_s=t1 - t0)
        return stats

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
        sampling every batch (reference main.py:204-211); logs the final
        stats and returns the ``FINAL SUMMARY:`` line."""
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
        """Every node of each mode's node set through the evaluation path
        (a mode's cache where one is built, else sampling), in node-set
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
            nb, roots, rows, _labels, w = self._epoch_arrays(md, ordered=True)
            gen = torch.Generator(device=self.device).manual_seed(SERVE_SEED)
            n_valid = int((w > 0).sum())           # the padding rows come last
            ids = torch.as_tensor(roots[:n_valid, 0].astype(np.int64),
                                  device=self.device)
            with torch.inference_mode():
                for sl, batches, feats in self._batches(md, nb, roots, rows, gen):
                    logits, embs = self.model(batches, feats, mode_train=md == TRAIN)
                    res = embs if embed else [predict_fn(self.model_cfg, logits)]
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
        with torch.inference_mode():
            batches, feats = self._sample_branch_batches(
                mode, torch.as_tensor(ids[:, None], device=self.device),
                torch.as_tensor(rows[:, None], device=self.device),
                torch.Generator(device=self.device).manual_seed(SERVE_SEED))
            logits, emb_ens = self.model(batches, feats)
            probs = predict_fn(self.model_cfg, logits)[:n].cpu().numpy()
            embs = torch.stack(emb_ens)[:, :n].cpu().numpy()
        return probs, embs

    def predict_nodes(self, ids, mode: int = TEST) -> np.ndarray:
        """Point-query serving: class probabilities [len(ids), C] for node
        ids of the mode's node set (PPR-row gather -> cached subgraph ->
        forward)."""
        return self._serve_batch(ids, mode, "predict_nodes")[0]

    def embed_nodes(self, ids, mode: int = TEST) -> List[np.ndarray]:
        """Point-query embeddings: per-ensemble-branch [len(ids), dim]."""
        embs = self._serve_batch(ids, mode, "embed_nodes")[1]
        return [embs[i] for i in range(self.num_ensemble)]
