"""Carry weights from the JAX package to the port.

:func:`params_from_flax` maps the flax parameter tree of a
single-branch ``DeepGNN`` (SAGE or GAT, as numpy arrays) to the
``state_dict`` of :class:`shadow_gnn_torch.nn.model.DeepGNN`:

  aug_0_<aug>/kernel [in, out]            -> aug.<aug>.weight [out, in]
  conv_0_<l>/TorchLinear_0 (self linear)  -> convs.<l>.lin_self
  conv_0_<l>/TorchLinear_1 (neigh linear) -> convs.<l>.lin_neigh
  conv_0_<l>/Act_0/prelu_alpha            -> convs.<l>.act.prelu_alpha
  conv_0_<l>/scale, offset                -> convs.<l>.scale, .offset
      ([2, dim] for SAGE, [2, H, dh] for GAT)
  conv_0_<l>/attention [2, H, dh] (GAT)   -> convs.<l>.attention
  res_pool_0/TorchLinear_0                -> res_pool.lin
  res_pool_0/Act_0/prelu_alpha            -> res_pool.act.prelu_alpha
  res_pool_0/scale, offset [dim]          -> res_pool.scale, .offset
  classifier_<l>/TorchLinear_0            -> classifier.<l>.lin
  classifier_<l>/Act_0/prelu_alpha        -> classifier.<l>.act.prelu_alpha
  classifier_<l>/scale, offset            -> classifier.<l>.scale, .offset
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree (``{"params": {...}}`` or its inner dict) of
    numpy arrays -> the port's ``state_dict``."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for name, sub in p.items():
        parts = name.split("_")
        branch = parts[2] if name.startswith("res_pool_") else parts[1]
        if parts[0] in ("aug", "conv", "res") and branch != "0":
            raise NotImplementedError("only one ensemble branch is ported")
        if parts[0] == "aug":
            _linear(sub, f"aug.{'_'.join(parts[2:])}", out)
        elif parts[0] == "conv":
            _module(sub, f"convs.{parts[2]}",
                    {"TorchLinear_0": "lin_self", "TorchLinear_1": "lin_neigh"}, out)
        elif name.startswith("res_pool_"):
            _module(sub, "res_pool", {"TorchLinear_0": "lin"}, out)
        elif parts[0] == "classifier":
            _module(sub, f"classifier.{parts[1]}", {"TorchLinear_0": "lin"}, out)
        else:
            raise NotImplementedError(f"no port of parameter group {name!r}")
    return out
