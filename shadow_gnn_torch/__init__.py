"""shaDow-GNN on PyTorch and CUDA: the port of ``shadow_gnn_tpu``.

The module layout follows the JAX package, so each module here has a
counterpart of the same path there.  This package imports ``torch``,
numpy and scipy only; it never imports JAX or ``shadow_gnn_tpu``.

Subpackages
-----------
data      RawGraph / DeviceGraph, shaDow on-disk format IO, synthetic graphs
native    C++ forward-push PPR precompute (built on first use)
sampling  PPR tables, the PPR sampler, row induction, bit-packed cache
ops       dense adjacency normalisation and the packed aggregation kernel
csrc      CUDA sources of the hand-written kernels
nn        SAGE layers, ResPool, DeepGNN
train     config parsing and the serving Trainer
convert   flax parameter tree -> state_dict
"""

TRAIN, VALID, TEST = 0, 1, 2
MODE2STR = {TRAIN: "train", VALID: "valid", TEST: "test"}
