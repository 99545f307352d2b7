"""Post-processing entry points: Correct & Smooth or the subgraph ensemble.

The port of the JAX package's ``postproc/driver.py`` (reference
main.py:214-296): the post-processing config names stored run dirs; a
prediction or embedding matrix that a run dir does not hold is made by
inference with the run's newest checkpoint first.  Reading the yml
(:func:`load_postproc_config`) is apart from running the config
(:func:`run_postproc` takes the dict), so that a caller without a yml
parser can pass a dict.  Trainers are built on ``args.device`` with the
CLI's precision flags.  A C&S config's ``n_shards`` > 0 runs the
edge-partitioned propagation over that many local ranks, spawned by
``postproc/cns.py:run_correct_smooth``.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from shadow_gnn_torch import TEST, TRAIN, VALID


def load_postproc_config(path: str) -> dict:
    """The post-processing config at ``path`` (JSON or YAML)."""
    from shadow_gnn_torch.train.config import read_config_file
    return read_config_file(path)


def run_postproc(args, cfg=None) -> int:
    """``--postproc_configs``: ``cfg`` (default: the yml it names) with
    ``method`` ``cs`` or ``ensemble``."""
    if cfg is None:
        cfg = load_postproc_config(args.postproc_configs)
    method = cfg["method"].lower()
    if method == "cs":
        from shadow_gnn_torch.postproc.cns import run_correct_smooth
        run_correct_smooth(args, cfg)
        return 0
    if method != "ensemble":
        raise ValueError(f"unknown post-processing method {method!r}")
    run_post_ensemble(args, cfg)
    return 0


def _build_trainer_from_run(args, run_dir: str):
    """(Trainer with the run's newest checkpoint loaded, parsed config):
    the run dir's one yml, the data of ``args``, seed 0, no log files."""
    from shadow_gnn_torch.data.loader import load_data
    from shadow_gnn_torch.train.config import DATA_METRIC, parse_config
    from shadow_gnn_torch.train.logger import Logger
    from shadow_gnn_torch.train.metrics import Metrics
    from shadow_gnn_torch.train.pipeline import Trainer

    ymls = [f for f in os.listdir(run_dir) if f.rsplit(".", 1)[-1] in ("yml", "yaml")]
    parsed = parse_config(f"{run_dir}/{ymls[0]}")
    m = Metrics(args.dataset, parsed["arch_gnn"]["loss"] == "sigmoid",
                DATA_METRIC.get(args.dataset, "accuracy"), 1)
    raw = load_data(args.data_dir, args.dataset, parsed["config_data"])
    tr = Trainer(args.dataset, args.data_dir, raw, parsed, m,
                 Logger(m, run_dir, no_log=True), seed=0, device=args.device,
                 packed_adj=getattr(args, "packed_adj", False),
                 matmul_precision=getattr(args, "matmul_precision", None),
                 compute_dtype=getattr(args, "compute_dtype", "float32"),
                 feat_dtype=getattr(args, "feat_dtype", "float32"))
    tr.load_run(run_dir)
    return tr, parsed


def run_post_ensemble(args, cfg: dict):
    """``method: ensemble``: per sampler type and run dir, the stored
    per-branch embedding matrices (or ``embed_full`` of the run, saved
    as ``emb_mat_<i>.npy``), then the post-ensembler trained on them
    (reference main.py:266-293).  Prints and returns {mode: accuracy
    list}."""
    from shadow_gnn_torch.postproc.ens import ensemble_multirun

    emb_pipeline = {}
    label = node_set = None
    for sname, dirs in cfg["dir_emb_mat"].items():
        emb_pipeline[sname] = []
        for d in dirs:
            stored = (sorted(glob.glob(f"{d}/emb_mat_*.npy"))
                      + sorted(glob.glob(f"{d}/__emb_mat_*.npy")))
            if stored:
                embs = [np.load(s) for s in stored]
            else:
                tr, _ = _build_trainer_from_run(args, d)
                embs = tr.embed_full()
                for i, e in enumerate(embs):
                    np.save(f"{d}/emb_mat_{i}.npy", e)
                label, node_set = tr.label_np, tr.entity_set
            emb_pipeline[sname].append(embs)
    if label is None:
        from shadow_gnn_torch.data.loader import load_data
        raw = load_data(args.data_dir, args.dataset,
                        {"to_undirected": False, "transductive": True})
        label, node_set = raw.label_full, raw.node_set
    acc = ensemble_multirun(
        node_set, emb_pipeline, label,
        cfg.get("architecture", {"dim": 64, "act": "leakyrelu", "loss": "softmax"}),
        cfg.get("hyperparameter", {"lr": 0.01, "batch_size": 256, "end": 20,
                                   "dropout": 0.0}),
        repeat=int(cfg.get("repeat_per_emb", 2)), device=args.device)
    for m, name in ((TRAIN, "train"), (VALID, "valid"), (TEST, "test")):
        v = acc[m]
        print(f"post-ensemble {name}: mean {np.mean(v):.4f} "
              f"std {np.std(v):.4f} over {len(v)} runs")
    return acc
