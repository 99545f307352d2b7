"""Serving pipeline: data -> PPR tables -> subgraph cache -> model.

The serving subset of the JAX package's ``train/pipeline.py`` Trainer:
per-mode device graphs, per-mode PPR top-k tables (native host push +
the reference's bin cache), the bit-packed subgraph cache of the
deterministic PPR sampler, and point-query serving through
:meth:`Trainer.predict_nodes` / :meth:`Trainer.embed_nodes`.

Differences from the JAX Trainer:
* everything runs eagerly on ``device`` (default ``"cuda"``; CUDA
  absent raises); there are no epoch or chunk programs;
* serving builds the mode's subgraph cache on the first request (the
  JAX Trainer builds it in its first epoch of that mode), so requests
  read cached subgraphs unless :meth:`disable_cache` was called;
* training, the optimizer, the logger and the metrics are not ported
  yet, nor are samplers other than deterministic ``ppr``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
from shadow_gnn_torch.data.graph import DeviceGraph, RawGraph, is_undirected
from shadow_gnn_torch.nn.layers import init_params
from shadow_gnn_torch.nn.model import DeepGNN, ModelConfig, predict_fn
from shadow_gnn_torch.sampling import cache as cache_mod
from shadow_gnn_torch.sampling import ppr as ppr_mod
from shadow_gnn_torch.sampling.batch import SamplerConfig, SubgraphBatch, default_n_pad
from shadow_gnn_torch.sampling.induction import bucket_cap, plan_ppr_induction
from shadow_gnn_torch.sampling.samplers import PPRTables, sample_subgraphs
from shadow_gnn_torch.train.config import decouple_ensemble


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return dev


class Trainer:
    def __init__(self, name_data: str, dir_data: str, raw: RawGraph,
                 parsed: Dict[str, Any], seed: int = 0, device="cuda",
                 packed_adj: bool = False):
        self.device = resolve_device(device)
        self.name_data = name_data
        self.dir_data = dir_data
        self.arch = parsed["arch_gnn"]
        self.sampler_cfg_train = parsed["config_sampler_train"]
        self.config_data = parsed["config_data"]
        self.task = raw.prediction_task
        if self.task != "node":
            raise NotImplementedError("the link task is not ported yet")
        if (self.arch["feature_smoothen"] != "none"
                or self.arch["use_label"] != "none"):
            raise NotImplementedError("feature/label smoothening is not ported yet")
        self.seed = seed
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
        feat_np = np.asarray(raw.feat_full, dtype=np.float32)
        self.dim_feat_raw = feat_np.shape[1]
        label = raw.label_full
        self.entity_set = raw.node_set
        if label.ndim == 1:
            self.num_classes = int(label[~np.isnan(label.astype(np.float64))].max()) + 1
        else:
            self.num_classes = label.shape[1]
        self.num_targets = 1
        self.feat_tab = torch.as_tensor(feat_np, device=self.device)
        self.branches = self._build_branches()
        self.num_ensemble = len(self.branches)
        self.tables: Dict[int, List[PPRTables]] = {}
        self.caches: Dict[int, list] = {}
        self.nocache_modes = set()
        self.cache_budget_bytes = 2 << 30
        self.model_cfg = ModelConfig(
            dim_feat_smooth=self.dim_feat_raw,
            dim_label_raw=self.num_classes,
            dim_label_smooth=0,
            aggr=self.arch["aggr"],
            num_layers=self.arch["num_layers"],
            dim=self.arch["dim"],
            act=self.arch["act"],
            layer_norm=self.arch["layer_norm"],
            residue=self.arch["residue"],
            pooling=self.arch["pooling"],
            loss=self.arch["loss"],
            num_cls_layers=self.arch["num_cls_layers"],
            feature_augment=tuple(self.arch["feature_augment"]),
            feature_augment_ops=self.arch["feature_augment_ops"],
            num_ensemble=self.num_ensemble,
            prediction_task=self.task,
            packed_adj=packed_adj,
        )
        self.model = DeepGNN(self.model_cfg)
        init_params(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()
        self._lookup: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    def _build_branches(self) -> List[Dict[str, Any]]:
        """Decoupled per-branch sampler dicts -> per-mode SamplerConfigs."""
        branches = []
        aug = tuple(self.arch["feature_augment"])
        for cfg_d in decouple_ensemble(self.sampler_cfg_train["configs"]):
            if cfg_d["method"] != "ppr":
                raise NotImplementedError(
                    f"sampler {cfg_d['method']!r} is not ported yet (only ppr)")
            common = dict(
                method="ppr",
                n_pad=default_n_pad(cfg_d, self.num_targets),
                num_targets=self.num_targets,
                depth=int(cfg_d.get("depth", 2)),
                budget=int(cfg_d.get("budget", 20)),
                k=int(cfg_d.get("k", 200)),
                alpha=float(cfg_d.get("alpha", 0.85)),
                epsilon=float(cfg_d.get("epsilon", 1e-5)),
                threshold=float(cfg_d.get("threshold", 0.0)),
                add_self_edge=bool(cfg_d.get("add_self_edge", False)),
                include_target_conn=bool(cfg_d.get("include_target_conn", False)),
                aug_feats=aug,
            )
            branches.append({"raw": cfg_d, "cfg": {
                m: SamplerConfig(**common) for m in (TRAIN, VALID, TEST)}})
        return branches

    # ------------------------------------------------------------------
    def _ppr_targets(self, mode: int) -> np.ndarray:
        """Nodes that need PPR rows: the mode's node set."""
        return np.asarray(self.entity_set[mode], dtype=np.int64)

    def _ensure_tables(self, mode: int):
        """PPR top-k tables of every branch for ``mode``, on the device,
        and the exact induction sizing of each branch's scope."""
        if mode in self.tables:
            return
        tabs = []
        for br in self.branches:
            cfg = br["cfg"][mode]
            targets = self._ppr_targets(mode)
            neighs, scores = self._compute_ppr(mode, cfg, cfg.k, targets)
            tab_n, tab_s = ppr_mod.ppr_topk_tables(neighs, scores, cfg.k)
            deg = np.diff(self._host_adj[mode][0]).astype(np.int64)
            scope_deg = deg[np.clip(tab_n, 0, self.num_nodes - 1)] * (tab_n >= 0)
            fields = plan_ppr_induction(
                scope_deg, deg[targets], n_pad=cfg.n_pad,
                num_targets=self.num_targets, batch_size=self.batch_size,
                undirected=self.undirected)
            br["cfg"][mode] = dataclasses.replace(cfg, **fields)
            tabs.append(PPRTables(
                torch.as_tensor(tab_n.astype(np.int64), device=self.device),
                torch.as_tensor(tab_s, device=self.device)))
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
        """Build each branch's bit-packed subgraph cache for ``mode``
        (memory-gated; a branch over budget samples every request)."""
        if mode in self.caches or mode in self.nocache_modes:
            self.caches.setdefault(mode, [None] * self.num_ensemble)
            return
        self._ensure_tables(mode)
        self.caches[mode] = [None] * self.num_ensemble
        ent = self._ppr_targets(mode)
        for i, br in enumerate(self.branches):
            cfg = br["cfg"][mode]
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
                               rows: torch.Tensor
                               ) -> Tuple[List[SubgraphBatch], List[torch.Tensor]]:
        batches, feats = [], []
        for i, br in enumerate(self.branches):
            cfg = br["cfg"][mode]
            cache = self.caches.get(mode, [None] * self.num_ensemble)[i]
            if cache is not None:
                # with packed_adj the kernel reads adj_bits and no dense
                # block is unpacked
                batch = cache_mod.gather_batch(
                    cache, rows[:, 0], cfg.n_pad, self.num_nodes,
                    unpack=not self.model_cfg.packed_adj)
            else:
                batch = sample_subgraphs(cfg, self.graph[mode], roots, rows,
                                         self.tables[mode][i])
            feats.append(self.feat_tab[torch.clamp(batch.nodes, 0,
                                                   self.num_nodes - 1)])
            batches.append(batch)
        return batches, feats

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

    def _serve_batch(self, ids, mode: int):
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
                torch.as_tensor(rows[:, None], device=self.device))
            logits, emb_ens = self.model(batches[0], feats[0])
            probs = predict_fn(self.model_cfg, logits)[:n].cpu().numpy()
            embs = torch.stack(emb_ens)[:, :n].cpu().numpy()
        return probs, embs

    def predict_nodes(self, ids, mode: int = TEST) -> np.ndarray:
        """Point-query serving: class probabilities [len(ids), C] for node
        ids of the mode's node set (PPR-row gather -> cached subgraph ->
        forward)."""
        return self._serve_batch(ids, mode)[0]

    def embed_nodes(self, ids, mode: int = TEST) -> List[np.ndarray]:
        """Point-query embeddings: per-ensemble-branch [len(ids), dim]."""
        embs = self._serve_batch(ids, mode)[1]
        return [embs[i] for i in range(self.num_ensemble)]
