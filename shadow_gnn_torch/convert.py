"""Carry weights from the JAX package to the port.

:func:`params_from_flax` maps the flax parameter tree of a ``DeepGNN``
(SAGE or GAT, one or more ensemble branches, as numpy arrays) to the
``state_dict`` of :class:`shadow_gnn_torch.nn.model.DeepGNN`.  Branch
i's modules carry the suffix ``<s>`` = ``_<i>`` (none for branch 0,
``nn/model.py:branch_suffix``):

  aug_<i>_<aug>/kernel [in, out]          -> aug<s>.<aug>.weight [out, in]
      (out = dim_feat_in, or dim under feature_augment_ops: concat)
  conv_<i>_<l>/TorchLinear_0 (self)       -> convs<s>.<l>.lin_self
  conv_<i>_<l>/TorchLinear_1 (neigh)      -> convs<s>.<l>.lin_neigh
  conv_<i>_<l>/Act_0/prelu_alpha          -> convs<s>.<l>.act.prelu_alpha
  conv_<i>_<l>/scale, offset              -> convs<s>.<l>.scale, .offset
      ([2, dim] for SAGE, [2, H, dh] for GAT)
  conv_<i>_<l>/attention [2, H, dh] (GAT) -> convs<s>.<l>.attention
  res_pool_<i>/TorchLinear_0              -> res_pool<s>.lin
      (sort-k pooling: TorchLinear_0 -> res_pool<s>.nn_pool, the
      [k*F, F] linear, and TorchLinear_1 -> res_pool<s>.lin)
  res_pool_<i>/Act_0/prelu_alpha          -> res_pool<s>.act.prelu_alpha
  res_pool_<i>/scale, offset [dim]        -> res_pool<s>.scale, .offset
  ensembler/TorchLinear_0, Act_0, q       -> ensembler.lin, .act, .q
  classifier_<l>/TorchLinear_0            -> classifier.<l>.lin
  classifier_<l>/Act_0/prelu_alpha        -> classifier.<l>.act.prelu_alpha
  classifier_<l>/scale, offset            -> classifier.<l>.scale, .offset
      (dropped for the link task: JAX makes them, its classifier never
      reads them, and the port's has none)

:func:`post_ens_params_from_flax` maps the tree of the post-ensemble's
``ModelPostEns`` (``postproc/ens.py``):

  EnsembleAggregator_0/TorchLinear_0, Act_0, q -> ensembler.lin, .act, .q
  MLPLayer_0/TorchLinear_0                     -> classifier.lin
  MLPLayer_0/scale, offset                     -> classifier.scale, .offset
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from shadow_gnn_torch.nn.model import branch_suffix


def _linear(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]):
    out[f"{prefix}.weight"] = torch.as_tensor(np.asarray(tree["kernel"]).T.copy())
    if "bias" in tree:
        out[f"{prefix}.bias"] = torch.as_tensor(np.array(tree["bias"]))


def _module(tree: Mapping, prefix: str, linears: Mapping[str, str],
            out: Dict[str, torch.Tensor]):
    """One flax module's parameters: its linears renamed by ``linears``,
    its activation's PReLU slope, and its own arrays by name."""
    for key, sub in tree.items():
        if key in linears:
            _linear(sub, f"{prefix}.{linears[key]}", out)
        elif key == "Act_0":
            out[f"{prefix}.act.prelu_alpha"] = torch.as_tensor(
                np.array(sub["prelu_alpha"]))
        elif isinstance(sub, Mapping):
            raise NotImplementedError(f"no port of parameter group {prefix}/{key}")
        else:
            out[f"{prefix}.{key}"] = torch.as_tensor(np.array(sub))


def params_from_flax(params: Mapping, prediction_task: str = "node"
                     ) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree (``{"params": {...}}`` or its inner dict) of
    numpy arrays -> the port's ``state_dict``."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for name, sub in p.items():
        parts = name.split("_")
        if parts[0] in ("aug", "conv"):
            sfx = branch_suffix(int(parts[1]))
        elif name.startswith("res_pool_"):
            sfx = branch_suffix(int(parts[2]))
        if parts[0] == "aug":
            _linear(sub, f"aug{sfx}.{'_'.join(parts[2:])}", out)
        elif parts[0] == "conv":
            _module(sub, f"convs{sfx}.{parts[2]}",
                    {"TorchLinear_0": "lin_self", "TorchLinear_1": "lin_neigh"}, out)
        elif name.startswith("res_pool_"):
            lins = ({"TorchLinear_0": "nn_pool", "TorchLinear_1": "lin"}
                    if "TorchLinear_1" in sub else {"TorchLinear_0": "lin"})
            _module(sub, f"res_pool{sfx}", lins, out)
        elif name == "ensembler":
            _module(sub, "ensembler", {"TorchLinear_0": "lin"}, out)
        elif parts[0] == "classifier":
            if prediction_task == "link":
                sub = {k: v for k, v in sub.items()
                       if k not in ("scale", "offset")}
            _module(sub, f"classifier.{parts[1]}", {"TorchLinear_0": "lin"}, out)
        else:
            raise NotImplementedError(f"no port of parameter group {name!r}")
    return out


def post_ens_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``ModelPostEns`` tree (``{"params": {...}}`` or its inner
    dict) of numpy arrays -> the ``state_dict`` of
    :class:`shadow_gnn_torch.postproc.ens.ModelPostEns`."""
    p = params.get("params", params)
    names = {"EnsembleAggregator_0": "ensembler", "MLPLayer_0": "classifier"}
    out: Dict[str, torch.Tensor] = {}
    for name, sub in p.items():
        if name not in names:
            raise NotImplementedError(f"no port of parameter group {name!r}")
        _module(sub, names[name], {"TorchLinear_0": "lin"}, out)
    return out
