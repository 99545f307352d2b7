"""shaDow-GNN on PyTorch and CUDA: the port of ``shadow_gnn_tpu``.

The module layout follows the JAX package, so each module here has a
counterpart of the same path there.  This package imports ``torch``,
numpy and scipy (and PyYAML only where a yml file is read or written);
it never imports JAX or ``shadow_gnn_tpu``.

Subpackages
-----------
data      RawGraph / DeviceGraph, shaDow on-disk format IO, synthetic graphs
native    C++ forward-push PPR precompute (built on first use)
sampling  PPR tables, the PPR sampler, row induction, bit-packed cache
ops       dense adjacency normalisation, the dropedge mask and the
          packed aggregation kernels
csrc      CUDA sources of the hand-written kernels
nn        SAGE layers and dropout, ResPool, DeepGNN, loss_fn
train     config parsing, the Trainer (training and serving), metrics,
          the logger
convert   flax parameter tree -> state_dict
main      the training CLI (``python -m shadow_gnn_torch.main``)
"""

TRAIN, VALID, TEST = 0, 1, 2
MODE2STR = {TRAIN: "train", VALID: "valid", TEST: "test"}
STR2MODE = {v: k for k, v in MODE2STR.items()}
