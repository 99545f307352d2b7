"""Config parsing: training yml (or dict) -> validated config dicts.

The reference's per-run yml schema (``data:/architecture:/
hyperparameter:/sampler:`` with list-valued sampler keys for ensemble
width), with the same defaults and validation as the JAX package's
``train/config.py``.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List

DEFAULT_DATA = {
    "to_undirected": False,
    "transductive": False,
    "norm_feat": True,
    "valedges_as_input": False,
}

DEFAULT_ARCH = {
    "dim": -1,
    "aggr": "sage",
    "residue": "none",
    "pooling": "center",
    "loss": "softmax",
    "num_layers": -1,
    "num_cls_layers": 1,
    "act": "I",
    "layer_norm": "norm_feat",
    "heads": -1,
    "feature_augment": "hops",
    "feature_augment_ops": "sum",
    "feature_smoothen": "none",
    "label_smoothen": "none",
    "ensemble_act": "leakyrelu",
    "branch_sharing": False,
    "use_label": "none",
}

DEFAULT_PARAMS = {
    "lr": 0.01,
    "dropedge": 0.0,
    "ensemble_dropout": "none",
    "term_window_size": 1,
    "term_window_aggr": "center",
    "percent_per_epoch": {"train": 1.0, "valid": 1.0, "test": 1.0},
}

# per-dataset metric (reference CONFIG_TEMPLATE.yml:5-13)
DATA_METRIC = {
    "flickr": "accuracy",
    "reddit": "accuracy",
    "yelp": "f1",
    "arxiv": "accuracy_ogb",
    "products": "accuracy_ogb",
    "papers100M": "accuracy_ogb",
    "collab": "hits50",
    "ppa": "hits100",
}


class ConfigFileError(ValueError):
    """A config file that neither the JSON nor the YAML reader parses."""


def read_config_file(path: str, what: str = "config") -> Dict[str, Any]:
    """The dict of the config file at ``path`` (``what`` names it in an
    error): JSON (which is YAML too, and needs no PyYAML, which a machine
    may lack), else YAML; raises ConfigFileError when neither reader
    parses it."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text) or {}
    except json.JSONDecodeError as e:
        json_err = e
    try:
        import yaml
    except ImportError:
        raise ConfigFileError(f"{what} {path}: not JSON ({json_err}) and PyYAML "
                              "is not installed to read YAML") from None
    try:
        return yaml.safe_load(text) or {}
    except yaml.YAMLError as e:
        raise ConfigFileError(f"{what} {path}: neither JSON ({json_err}) nor YAML "
                              f"({e})") from None


def _check(ok: bool, what: str):
    if not ok:
        raise ValueError(f"invalid config: {what}")


def parse_config(path_or_dict) -> Dict[str, Any]:
    """Parse + validate a training yml.  Returns a dict with keys
    params_train, config_sampler_preproc, config_sampler_train,
    config_data, arch_gnn."""
    if isinstance(path_or_dict, dict):
        raw = copy.deepcopy(path_or_dict)
    else:
        raw = read_config_file(path_or_dict)

    config_data = dict(DEFAULT_DATA)
    config_data.update(raw.get("data", {}))

    arch = dict(DEFAULT_ARCH)
    arch.update(raw["architecture"])
    for k, v in arch.items():
        if isinstance(v, str):
            arch[k] = v.lower()
    _check(arch["aggr"] in ["sage", "gat", "gatscat", "gcn", "mlp", "gin",
                            "sgc", "sign"], f"aggr {arch['aggr']}")
    _check(arch["use_label"] in ["all", "none", "no_valid"], "use_label")
    _check(arch["pooling"].split("-")[0] in ["mean", "max", "sum", "center",
                                             "sort"], "pooling")
    _check(arch["residue"] in ["sum", "concat", "max", "none"], "residue")
    _check(arch["feature_augment"] in ["hops", "pprs", "none", "hops-pprs",
                                       "drnls"], "feature_augment")
    _check(arch["feature_augment_ops"] in ["concat", "sum"], "feature_augment_ops")
    _check(arch["layer_norm"] in ["norm_feat", "pairnorm"], "layer_norm")
    if arch["feature_augment"] and arch["feature_augment"] != "none":
        arch["feature_augment"] = tuple(sorted(arch["feature_augment"].split("-")))
    else:
        arch["feature_augment"] = ()

    params = dict(DEFAULT_PARAMS)
    params.update(raw["hyperparameter"])
    params["lr"] = float(params["lr"])
    for m in ("train", "valid", "test"):
        params["percent_per_epoch"].setdefault(m, 1.0)
        _check(0 <= params["percent_per_epoch"][m] <= 1.0, "percent_per_epoch")

    sampler_preproc, sampler_train = [], []
    for s in copy.deepcopy(raw["sampler"]):
        phase = s.pop("phase")
        (sampler_preproc if phase == "preprocess" else sampler_train).append(s)
    batch_size = raw["hyperparameter"]["batch_size"]
    # self-edges forced for gcn/gat/gatscat (reference utils.py:126-131)
    if arch["aggr"] in ("gcn", "gat", "gatscat"):
        for sc in sampler_train:
            num_ens = [len(v) for k, v in sc.items() if k != "method"]
            width = num_ens[0] if num_ens else 1
            sc["add_self_edge"] = [True] * width
    return {
        "params_train": params,
        "config_sampler_preproc": {"batch_size": batch_size,
                                   "configs": sampler_preproc},
        "config_sampler_train": {"batch_size": batch_size,
                                 "configs": sampler_train},
        "config_data": config_data,
        "arch_gnn": arch,
    }


def decouple_ensemble(configs: List[dict]) -> List[dict]:
    """Expand list-valued sampler configs into per-branch dicts:
    {"method": "ppr", "k": [50, 10]} -> [{"method": "ppr", "k": 50},
    {"method": "ppr", "k": 10}]."""
    out = []
    for cfg in copy.deepcopy(configs):
        method = cfg.pop("method")
        widths = [len(v) for v in cfg.values()]
        _check(not widths or max(widths) == min(widths),
               "ensemble sampler lists differ in length")
        width = widths[0] if widths else 1
        cfg["method"] = [method] * width
        out.extend({k: v[i] for k, v in cfg.items()} for i in range(width))
    return out
