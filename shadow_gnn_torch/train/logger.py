"""Run logging, CSV protocol, windowed best-model tracking, checkpoints.

The port of the JAX package's ``train/logger.py`` (reference
``shaDow/logging_base.py``): per-epoch CSV files
``epoch_{train,valid,test}.csv`` and the single-row ``final.csv``, the
sliding-window best-model selection with its representative epoch
(center / last / best_<metric>), the ``FINAL SUMMARY:`` line read by
the multi-run wrapper, and the run-dir move running -> finished /
killed / crashed.  Checkpoints are ``torch.save`` state dicts of the
model and the optimizer (``saved_model_<ts>.pt``,
``saved_optimizer_<ts>.pt``).
"""
from __future__ import annotations

import glob
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
from shadow_gnn_torch.train.metrics import Metrics


def host_copy(obj: Any) -> Any:
    """A copy of a (nested) state dict with every tensor cloned to the
    CPU, so that later in-place updates do not reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


class Logger:
    def __init__(self, metrics: Metrics, dir_log: str, *,
                 term_window_size: int = 1, term_window_aggr: str = "center",
                 timestamp: Optional[str] = None, no_log: bool = False,
                 config_dump: Optional[dict] = None):
        self.metrics = metrics
        self.no_log = no_log
        self.dir_log = dir_log
        self.timestamp = timestamp or time.strftime("%Y-%m-%d %H-%M-%S")
        self.window_size = term_window_size
        self.window_aggr = term_window_aggr
        if not (term_window_aggr in ("center", "last")
                or term_window_aggr.startswith("best")):
            raise ValueError(f"unknown term_window_aggr {term_window_aggr!r}")
        if not no_log:
            os.makedirs(dir_log, exist_ok=True)
            if config_dump is not None:
                import yaml
                with open(f"{dir_log}/config.yml", "w") as f:
                    yaml.dump(config_dump, f, default_flow_style=False,
                              sort_keys=False)
        # per-mode per-epoch histories
        self.epoch_stats: Dict[int, List[Dict[str, float]]] = {
            TRAIN: [], VALID: [], TEST: []}
        # most recent TRAIN epoch index: VALID/TEST csv rows carry it
        self._train_epoch = -1
        self._final_header_done = False
        # windowed best tracking over VALID
        self.loss_min_hist = float("inf")
        self.metric_max_hist = float("-inf")
        self.best_epoch = -1
        self._window: List[Any] = []    # [(epoch, model_sd, optimizer_sd)]
        self.best_state = None          # (epoch, model_sd, optimizer_sd)
        self.final_stats: Dict[int, Dict[str, float]] = {}

    # ---------------- CSV protocol ----------------
    def _csv_path(self, mode):
        return f"{self.dir_log}/epoch_{MODE2STR[mode]}.csv"

    def log_epoch(self, mode: int, epoch: int, stats: Dict[str, float],
                  status: str = "running", time_s: float = 0.0):
        self.epoch_stats[mode].append(dict(stats))
        mstr = " / ".join(f"{k} = {v:.5f}" for k, v in stats.items())
        print(f"[{MODE2STR[mode]:^5s}] ep {epoch:4d} ({status}): {mstr}"
              f"  ({time_s:.2f}s)")
        if status == "running" and mode == TRAIN:
            self._train_epoch = epoch
        if self.no_log or status != "running":
            return
        # header 'epoch, {mode}_loss, {mode}_{metric}...'; TRAIN rows lead
        # with the epoch index, VALID/TEST rows annotate it with the
        # train epoch they interleave: '{e:4d} ({train_e:4d})'
        path = self._csv_path(mode)
        ms = MODE2STR[mode]
        keys = [k for k in stats if k != "loss"]
        with open(path, "a") as f:
            if f.tell() == 0:
                f.write(f"epoch, {ms}_loss, "
                        + ", ".join(f"{ms}_{k}" for k in keys) + "\n")
            if mode == TRAIN:
                head = f"{epoch:4d}"
            else:
                head = f"{epoch:4d} ({self._train_epoch:4d})"
            f.write(head + ", " + f"{stats['loss']:.5f}, "
                    + ", ".join(f"{stats[k]:.5f}" for k in keys) + "\n")

    def log_final(self, mode: int, stats: Dict[str, float]):
        self.final_stats[mode] = dict(stats)
        if self.no_log:
            return
        # ONE header row spanning train/valid/test columns, then ONE data
        # row assembled incrementally (', ' after train/valid, newline
        # after test)
        path = f"{self.dir_log}/final.csv"
        keys = [k for k in stats if k != "loss"]
        with open(path, "a") as f:
            if not self._final_header_done and f.tell() == 0:
                f.write(", ".join(
                    f"{MODE2STR[m]}_loss, "
                    + ", ".join(f"{MODE2STR[m]}_{k}" for k in keys)
                    for m in (TRAIN, VALID, TEST)) + "\n")
                self._final_header_done = True
            frag = (f"{stats['loss']:.5f}, "
                    + ", ".join(f"{stats[k]:.5f}" for k in keys))
            f.write(frag + ("\n" if mode == TEST else ", "))

    def final_summary(self):
        """The machine-readable line scraped by the multi-run wrapper."""
        parts = []
        for mode in (TRAIN, VALID, TEST):
            if mode in self.final_stats:
                s = self.final_stats[mode]
                parts.append(f"{MODE2STR[mode]}: " + ", ".join(
                    f"{k}={v:.5f}" for k, v in s.items()))
        line = f"FINAL SUMMARY: best epoch {self.best_epoch} | " + " | ".join(parts)
        print(line)
        return line

    # ---------------- best-model window ----------------
    def update_best_model(self, epoch: int, model_sd, optimizer_sd) -> bool:
        """Track a sliding window of host-copied states; when the
        window-averaged validation metric improves, elect the window's
        representative."""
        key = self.metrics.metric_term[0]
        valid_hist = self.epoch_stats[VALID]
        loss_all = [s["loss"] for s in valid_hist]
        metric_all = [s[key] for s in valid_hist]
        self._window.append((epoch, host_copy(model_sd), host_copy(optimizer_sd)))
        if len(self._window) > self.window_size:
            self._window.pop(0)
        better, self.loss_min_hist, self.metric_max_hist = \
            self.metrics.is_better(loss_all, self.loss_min_hist,
                                   metric_all, self.metric_max_hist)
        if better and len(self._window) == min(self.window_size, len(valid_hist)):
            if self.window_aggr == "center":
                pick = len(self._window) // 2
            elif self.window_aggr == "last":
                pick = len(self._window) - 1
            else:                                  # best_<metric> in window
                win_metrics = metric_all[-len(self._window):]
                pick = int(np.argmax(win_metrics))
            self.best_state = self._window[pick]
            self.best_epoch = self.best_state[0]
            self.save_checkpoint(self.best_state[1], self.best_state[2])
        return better

    # ---------------- checkpointing ----------------
    def _ckpt_paths(self):
        ts = self.timestamp.replace(" ", "_")
        return (f"{self.dir_log}/saved_model_{ts}.pt",
                f"{self.dir_log}/saved_optimizer_{ts}.pt")

    def save_checkpoint(self, model_sd, optimizer_sd):
        if self.no_log:
            return
        pm, po = self._ckpt_paths()
        torch.save(model_sd, pm)
        torch.save(optimizer_sd, po)

    def restore_model(self):
        """The best (model state dict, optimizer state dict): from the
        in-memory window if present, else from the saved checkpoint."""
        if self.best_state is not None:
            return self.best_state[1], self.best_state[2]
        pm, po = self._ckpt_paths()
        if not os.path.isfile(pm):
            return None, None
        return self.load_checkpoint(pm, po)

    @staticmethod
    def load_checkpoint(path_model: str, path_opt: Optional[str] = None):
        """(model state dict, optimizer state dict or None), on the CPU;
        a path may be a glob (its first match is read)."""
        if "*" in path_model:
            path_model = sorted(glob.glob(path_model))[0]
        model_sd = torch.load(path_model, map_location="cpu", weights_only=True)
        opt_sd = None
        if path_opt:
            if "*" in path_opt:
                path_opt = sorted(glob.glob(path_opt))[0]
            opt_sd = torch.load(path_opt, map_location="cpu", weights_only=True)
        return model_sd, opt_sd

    def validate_result(self):
        """Recompute the window-best validation metric with an
        independent unfold and compare it with the incremental tracker."""
        key = self.metrics.metric_term[0]
        hist = [s[key] for s in self.epoch_stats[VALID]]
        if not hist:
            return True
        w = self.window_size
        best = max(sum(hist[max(0, i + 1 - w):i + 1])
                   / len(hist[max(0, i + 1 - w):i + 1])
                   for i in range(len(hist)))
        if abs(best - self.metric_max_hist) >= 1e-9:
            raise AssertionError(
                f"window tracker mismatch: {best} vs {self.metric_max_hist}")
        return True

    # ---------------- run-dir lifecycle ----------------
    def end_training(self, status: str):
        """Move the run dir running/ -> finished|killed|crashed."""
        self.final_summary()
        if self.no_log or "/running/" not in self.dir_log:
            return self.dir_log
        dest = self.dir_log.replace("/running/", f"/{status}/")
        os.makedirs(os.path.dirname(dest.rstrip("/")), exist_ok=True)
        shutil.move(self.dir_log, dest)
        self.dir_log = dest
        return dest
