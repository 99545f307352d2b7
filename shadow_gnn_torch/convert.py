"""Carry weights from the JAX package to the port.

:func:`params_from_flax` maps the flax parameter tree of a
single-branch SAGE ``DeepGNN`` (as numpy arrays) to the ``state_dict``
of :class:`shadow_gnn_torch.nn.model.DeepGNN`:

  aug_0_<aug>/kernel [in, out]            -> aug.<aug>.weight [out, in]
  conv_0_<l>/TorchLinear_0 (self linear)  -> convs.<l>.lin_self
  conv_0_<l>/TorchLinear_1 (neigh linear) -> convs.<l>.lin_neigh
  conv_0_<l>/scale, offset [2, dim]       -> convs.<l>.scale, .offset
  classifier_<l>/TorchLinear_0            -> classifier.<l>.lin
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


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree (``{"params": {...}}`` or its inner dict) of
    numpy arrays -> the port's ``state_dict``."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for name, sub in p.items():
        parts = name.split("_")
        if parts[0] == "aug":
            if parts[1] != "0":
                raise NotImplementedError("only one ensemble branch is ported")
            _linear(sub, f"aug.{'_'.join(parts[2:])}", out)
        elif parts[0] == "conv":
            if parts[1] != "0":
                raise NotImplementedError("only one ensemble branch is ported")
            pre = f"convs.{parts[2]}"
            _linear(sub["TorchLinear_0"], f"{pre}.lin_self", out)
            _linear(sub["TorchLinear_1"], f"{pre}.lin_neigh", out)
            out[f"{pre}.scale"] = torch.as_tensor(np.array(sub["scale"]))
            out[f"{pre}.offset"] = torch.as_tensor(np.array(sub["offset"]))
        elif parts[0] == "classifier":
            pre = f"classifier.{parts[1]}"
            _linear(sub["TorchLinear_0"], f"{pre}.lin", out)
            out[f"{pre}.scale"] = torch.as_tensor(np.array(sub["scale"]))
            out[f"{pre}.offset"] = torch.as_tensor(np.array(sub["offset"]))
        else:
            raise NotImplementedError(f"no port of parameter group {name!r}")
    return out
