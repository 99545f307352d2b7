"""shaDow-GNN on PyTorch and CUDA: the port of ``shadow_gnn_tpu``.

The module layout follows the JAX package, so each module here has a
counterpart of the same path there.  This package imports ``torch``,
numpy and scipy (and PyYAML only where a yml file is read or written);
it never imports JAX or ``shadow_gnn_tpu``.

Subpackages
-----------
data      RawGraph / DeviceGraph, shaDow on-disk format IO, synthetic
          graphs (the planted partition among them)
native    C++ forward-push PPR precompute (built on first use)
sampling  PPR tables, the PPR sampler, row induction, bit-packed cache
ops       dense adjacency normalisation, the dropedge mask and the
          packed aggregation kernels
csrc      CUDA sources of the hand-written kernels
nn        SAGE and GAT layers and dropout, ResPool, the ensemble
          aggregator, DeepGNN, loss_fn
train     config parsing, the Trainer (training, serving, reload,
          inference, full-graph prediction and embedding), metrics, the
          logger and its checkpoints, the inference cost count
parallel  partitioned training on torch.distributed, one process a
          device: process-group bring-up, the collectives, the dp /
          feat / edge steps, the ring SpMM and the edge-partitioned C&S
postproc  Correct & Smooth and the subgraph post-ensemble
convert   flax parameter trees -> state_dicts (DeepGNN, ModelPostEns)
main      the CLI (``python -m shadow_gnn_torch.main``): train,
          inference, post-processing
"""

TRAIN, VALID, TEST = 0, 1, 2
MODE2STR = {TRAIN: "train", VALID: "valid", TEST: "test"}
STR2MODE = {v: k for k, v in MODE2STR.items()}
