#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``shadow_gnn_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py             # every phase below but `profile`
    python3 chip_smoke.py --profile   # adds the torch.profiler phase
    python3 chip_smoke.py --parallel-nccl4   # only [parallel] and the
                                             # ring, at NCCL world 4
                                             # (four cards)

Phases, each fatal on failure (an uncaught exception, non-zero exit):

1. build   — compile every hand-written CUDA kernel from ``csrc/`` (one
             nvcc per source, all at once) and the native PPR push;
2. kernels — hold each kernel against its plain PyTorch version on the
             card: the forward ``packed_spmm`` and the transposed
             ``packed_spmm_t`` (all norms, dropedge 0, 0.05 and 0.5; N
             24/37/208 at F 37/256/500, B=256 at N=208, a 30%-dense block
             at N=208, the largest N the transposed kernel takes, 3592, at
             F 37, and the forward at N 6500, its tile built in
             sub-tiles), after printing their launch shape (clusters,
             lines a CTA, feature splits) and the largest N each takes;
             the transposed kernel must refuse N=3593; the GAT
             attention forward ``gat_attention`` (B2) and backward
             ``gat_attention_bwd`` (B3) at N 16/152/408 and the largest N
             they take (907), H 1/4, dh 8/128/200, with and without
             dropped edges (both must refuse N=908 and dh=264), on
             blocks about 10% dense with an
             empty row, a fully dropped row, a row whose max lies on a
             dropped edge and padded tail rows; max |kernel - plain| must
             stay below 1e-4 of max |plain| (d att_self, 0 up to
             rounding, below 1e-4 of the column sums' scale).  Then the
             bf16-precision product (``ops/precision.py``, a cuBLAS bf16
             GEMM with f32 output) against the f32 product of the rounded
             operands (1e-5 of max), and the bf16 levels at the same
             cases: B1c, the bf16 mode of both packed directions, with
             the weights' flipped roundings counted
             (``phase_kernels_bf16``); B2b/B3b
             at both levels with f32 and bf16 values, dv held with a
             counted slack for the roundings of P that a denominator
             summed in another order can flip (``phase_kernels_gat_bf16``);
3. serve   — the flagship SAGE-3 PPR-200 model at full width (dim 256,
             500 features, 7 classes; ``configs/flickr_sage_3_ppr.yml``)
             on the flickr-scale synthetic graph (89,250 nodes, avg deg
             10, seed 0), random weights from seed 0, TEST node set cut
             to its first 4096 nodes: ``Trainer.prepare_serving`` builds
             the PPR tables and the bit-packed cache on the card, then
             ``predict_nodes`` answers requests of 1, 8, 64 and 256 ids
             and ``embed_nodes`` requests of 64 ids.  The kernel counts
             are set to 0 just before and read just after: every request
             must launch ``packed_spmm`` exactly 3 times (once per
             layer).  Probabilities must be finite rows summing to 1,
             embeddings finite unit rows, and both must match the same
             requests served through the plain versions;
4. train   — the same trainer, TRAIN node set cut to its first 4096
             nodes (64 batches of 64) and VALID to 1024, 2 epochs
             (``end`` 2; the yml has 50), dropout 0.45, dropedge 0.05.
             First one TRAIN step's loss and gradients through the
             kernels and through the plain versions, from the same
             parameters, batch, dropout generator and dropedge seed
             (loss within 1e-5 relative, each gradient within 1e-4 of
             its max; see ``_first_step_agreement``).  Then ``Trainer.train()`` with the counts set to
             0 just before and read just after: every TRAIN step must
             launch ``packed_spmm`` 3 times and ``packed_spmm_t`` 3
             times, every evaluation batch 3 and 0; losses finite, the
             parameters moved; then ``predict_nodes`` still answers
             through 3 launches;
5. uncached — the trained model serves the same requests without the
             cache (sampling and induction per request, the dense
             aggregation) and must match the cached answers;
6. time    — each kernel, its plain version and one PyTorch library call
             of the same function (``torch.bmm`` on the normalised,
             edge-dropped dense block, or on its transpose), timed as
             CUDA-graph replays of 20 calls with CUDA events, on the
             cached bits: both packed directions at every serving batch
             (8, 64, 256), and at the training batch (64) with dropedge
             0.05;
             beside the least time the card could take (bytes over 3.35
             TB/s, operations over 67 TFLOP/s f32);
7. bf16    — phases 3-6 again for a flagship trainer built with
             ``matmul_precision="bfloat16"``: every request, TRAIN step
             and evaluation batch through B1c (3 forward launches; 3
             transposed per step), the first step held against the plain
             versions as in phase 4, B1c timed beside ``torch.bmm`` on
             the bf16 operands with an f32 output, with the cast of its f32
             operands in the timed call and without it;
8. matrix  — the rest of the model matrix on the same flickr-scale graph,
             each model ``configs/flickr_sage_3_ppr.yml`` with only
             ``aggr`` changed (the same cuts, 2 epochs, ``packed_adj``):
             GCN-3 (self edges forced, the packed kernels in ``sym``),
             GIN-3 (``gin``) and GATScatter-3 (4 heads, dh 64: B2/B3 with
             att_self = 0) each serve (``phase_serve``), train
             (``phase_train``: the first step against the plain versions,
             GIN's eps gradient within 1e-4 of the sum of the |terms|
             of its reduction, every other gradient of its max,
             every step's launches counted per norm, every other kernel
             count 0 over ``train()``) and serve uncached at 256 ids;
             then SIGN (``sym-3-concat`` smoothening on the card, 2,000
             input columns, no augment, the ``full`` train sampler, so
             nodeIID batches of one node) trains with every kernel
             count 0; final stats finite, accuracies in [0, 1], the
             parameters moved; B1a/B1b timed in ``sym`` and ``gin`` on
             the GCN and GIN TRAIN bits (``phase_time_train``); the
             phase's seconds printed (at most 200);
9. rest    — the remaining single-card capabilities on the same graph
             and cuts, 1 epoch each (``phase_rest``): GCN-3 and GIN-3 at
             ``matmul_precision="bfloat16"`` (B1c in ``sym`` and ``gin``)
             and GATScatter-3 at bf16 precision (B2b/B3b, att_self = 0),
             each through ``phase_train`` (first step against the plain
             versions within ``TOLS_BF16``, launches by norm and level,
             every other count 0 over ``train()``); the flagship at
             ``tensorfloat32`` (B1c rw, TF32 linears), its first step
             beside the f32 model's (printed, no bound), 2 epochs with
             epoch 1 traced (``--trace_dir``: the Chrome trace must name
             the packed kernels); the flagship with ``pairnorm``;
             ``smooth_signal_subgraph`` (ppr, sym-2-concat) on the card
             against the CPU (1e-5 of max); device PPR over the cut
             TRAIN, VALID and TEST (9,216 targets in 18 blocks of 512)
             timed beside the host push, one block against the CPU run
             (scores 1e-5 relative, neighbour sets equal outside ties)
             and a second card run (equal), the mean top-k overlap with
             the push's tables, 1 epoch from the device tables with the
             first epoch's subgraph profile printed; a synthetic OGB-raw
             archive (20,000 nodes, from seed 0, in a temp dir) through
             ``ingest_tarball``, ``load_data`` and a trainer, 1 epoch.
             The phase's seconds printed (at most ``REST_BUDGET_S``);
10. gat     — the products GAT-5 leaderboard model at full width
             (``configs/products_gat_5_ppr_leaderboard.yml``: dim 512, 4
             heads, 5 layers, prelu, max residue and pooling, ppr-
             smoothened label inputs, PPR k=150, batch 128, dropout 0.4,
             dropedge 0.1) on a products-width synthetic graph (250,000
             nodes, avg deg 15, 100 features, 47 classes, seed 0,
             uniform), TRAIN cut to 4096 nodes, VALID 1024, TEST 2048
             once the preprocessing has seen every TRAIN label, 2
             epochs, random weights (seed 0): the preprocessing, PPR and
             cache build times; ``predict_nodes`` at 1, 8, 64 and 128 ids
             (5 B2 launches per request; answers equal the plain
             versions'); the first TRAIN step through the kernels and the
             plain versions (loss to 1e-5 relative; gradients to 1e-4
             of their max against the plain backwards under the
             kernels' forward; the kinks the kernel and plain forwards
             cross counted, and the all-plain gradients held on a
             smooth witness model wherever a kink was crossed);
             ``train()`` with every TRAIN step launching
             B2 and B3 5 times each and every evaluation batch B2 5
             times; the same requests uncached (still 5 launches each);
             then B2 and B3 timed on cached TRAIN blocks (B=128, N=152,
             H=4, dh=128) beside their bound, plain versions and
             ``scaled_dot_product_attention``; their per-phase device
             clocks from an instrumented build of the same source, and
             their times with clusters of 1, 2 and 4 CTAs;
11. gat bf16 — the same with ``matmul_precision="bfloat16"`` (serving,
             first step, ``train()``: 5 B2b and 5 B3b launches per TRAIN
             step, 5 B2b per evaluation batch and request; B2b/B3b timed
             beside SDPA on bf16 operands, with and without the cast of its
             f32 operands), then with
             ``compute_dtype="bfloat16"`` and ``feat_dtype="bfloat16"``
             as well (a bf16 feature table, the dense path): serving, the
             first step and 1 epoch;
12. power   — the flagship SAGE-3 (f32, ``packed_adj``) on a power-law
             graph of the flickr scale (89,250 nodes, avg deg 10, 500
             features, 7 classes, seed 0, ``power_law=True``; max degree
             9,444), the same cuts, 1 epoch: each mode's induction plan
             printed (TRAIN must plan hub slots), serving through B1a and
             against the plain versions, ``train()`` through B1a/B1b, the
             hub-induced TRAIN blocks of the cache against the ``search``
             strategy on the same node tables (bit for bit), uncached
             serving against cached, then 10 cold (uncached) TRAIN steps
             timed (CUDA events; their split by stage is
             ``[sampled power]``'s);
13. ensemble — ``configs/arxiv_ensemble_ppr_khop.yml`` at full width
             (GAT, 2 heads, dim 256, 3 layers; a PPR-100 branch, n_pad
             104, and a khop depth-2 budget-10 branch, n_pad 112, softmax
             attention over the two) on an arxiv-width power-law graph
             (169,343 nodes, avg deg 13.7, 128 features, 40 classes, seed
             0), TRAIN 4096, VALID 1024, TEST 2048, 2 epochs: plans,
             serving (6 B2 launches a request; the khop picks seeded per
             request), the first-step check, ``train()`` with B2 and B3
             launched from both branches (counted by block width), the
             khop overflow, and 10 timed TRAIN steps (their split by
             stage is ``[sampled ensemble]``'s);
14. infer   — reload, inference and post-processing, each part run on
             the trainer of its model right after that model's training
             phase: the flagship (f32, its three caches built):
             ``predict_full`` over TRAIN, VALID and TEST from the caches
             (B1a 3 times a batch, B1b never), then an uncached VALID
             ``inference`` pass; the products GAT-5 (f32, trained): its
             checkpoint saved through a ``Logger`` and reloaded by a fresh
             trainer (``retrain_dir``), model and Adam state equal bit for
             bit, ``inference`` of VALID and TEST on both (B2 5 times a
             batch; accuracies equal, losses within 1e-6 relative),
             ``predict_full`` over the three modes (B2 5 times a batch)
             against ``predict_nodes`` on 256 VALID and TEST ids, and
             Correct & Smooth over the whole graph (250,000 nodes, 47
             classes, every TRAIN label known) on the card, without and
             with the symmetric scaling: ``correct_smooth`` timed, the
             propagation's ms a step and peak memory, the propagated
             matrix against the CPU's within ``TOL_CS``, the accuracy of
             the cut VALID and TEST sets before and after; the arxiv
             ensemble (trained): ``embed_full`` over the three modes with
             B2 launched 3 times a batch from each branch (counted by
             block width), the post-ensemble trained on the two matrices
             on the card (``ensemble_multirun``, one run of 5 epochs), and
             ``inference`` of VALID and TEST (6 B2 launches a batch).
             Each part prints its nodes per second and its seconds;
15. link    — ``configs/collab_sage_pprst_leaderboard.yml`` at full width
             (SAGE, 5 layers, dim 256, elu, DRNL one-hots concatenated,
             concat residue, sort-25 pooling; ppr_st k 200, threshold
             0.01, eps 1e-6, n_pad 408; batch 16, dropout 0.25, dropedge
             0.1, 10% of TRAIN an epoch; ``packed_adj`` on) on the
             collab-shape synthetic link graph of
             ``scripts/cold_bench.py`` (235,000 nodes, avg deg 10, 128
             features, seed 0), TRAIN positives cut to 20,480 edges of
             the message graph (256 steps an epoch with the trainer's
             negatives), 2 epochs: one device PPR power iteration over
             every node at k_tab 400 (``--device_ppr device``; the host
             push took 417-446 s and ``rest`` holds the two against each
             other), shared by the three modes (seconds printed), the
             plans; one TRAIN batch through the port on the card and on
             the CPU with the same parameters, roots and ppr_st uniforms
             at dropout and dropedge 0 (node tables, blocks, targets and
             DRNL equal bit for bit; loss within 1e-5 relative and each
             gradient within 1e-4 of its max on a batch whose sort-pool
             ranks do not swap; swaps counted); ``train()`` and then
             ``inference`` of VALID and TEST with every packed and GAT
             kernel count set to 0 just before and read as 0 just after
             (a link batch is never cached, so it takes the dense
             ``torch.bmm``; its DRNL BFS is the BFS kernel), finite
             losses, every parameter moved, hits@50 in [0, 1], the final
             stats reproduced by ``inference``, its edges per second;
             then 10 timed TRAIN steps (sampling included; their split
             by stage is ``[sampled link]``'s) and their device-busy
             share (torch.profiler; its top operations under
             ``--profile``), and the BFS kernel timed at the link's
             shape (S = 2);
16. parallel — partitioned training (``shadow_gnn_torch/parallel``),
             run twice: after ``rest`` the flagship (its cuts, dropout 0,
             dropedge 0, 1 epoch) and after the GAT-5 phases the GAT-5
             (the same), each rank a process spawned through
             ``parallel/launch.py`` (the CLI's entry) once the kernels are
             built: NCCL at world 1 (flagship ``dp`` and ``feat``, GAT-5
             ``edge``) and gloo at world 4 with every rank on cuda:0
             (flagship ``dp``, GAT-5 ``edge``; NCCL cannot hold two ranks
             on one card).  Each run against the single-card path on the
             same weights and features (the PPR tables through a PPR
             cache in a temp dir): the first TRAIN step's loss within
             1e-5 relative of the whole batch's, its gradients and
             updated parameters within 1e-5 of their max of the same
             step over the ranks' column slices (weights whose first
             Adam step still bends, |g| within 1e-5 of 0, held to Adam of
             the rank's gradient), ``edge``'s induced node tables, blocks
             and hops equal to the single card's bit for bit, the ranks'
             parameters bit-equal after the epoch, every rank's B1a/B1b
             (``dp``) or B2/B3 (``edge``) count above 0 over it, one VALID
             epoch's accuracy equal to the single card's on the same
             weights; then step ms a rank, the collectives' share of a
             timed window (gloo's host staging apart), rank 0's
             device-busy share and each rank's peak memory, one summary
             line a run and partition (the ranks' own lines in the log).
             On an NCCL run (the group whose collectives a CUDA graph
             holds) each rank also builds an eager twin
             (``cuda_graphs=False``) beside its graphed trainer: the
             epoch's per-step losses and predictions, the overflow,
             every kernel's launches, the collectives' calls and bytes,
             the parameters and Adam state, then the VALID pass, held
             bit for bit (``GRAPH_TOLS`` where not, printed), every
             TRAIN and VALID step but its key's first replayed; then 2
             rounds of eager, graphed, graphed, eager windows of 8 steps,
             and one window each under torch.profiler: step ms a rank,
             device-busy share, host CUDA calls and NCCL kernels' share
             of the device time a step.  A gloo run stays eager and says
             so (its ranks' plans).  A rank whose partition runs longer
             than ``PARALLEL_HANG_S`` dumps every thread's stack into its
             log and exits; the ranks' logs reach the full log also when
             a run fails.  With ``--parallel-nccl4`` a teardown check
             runs first: 4 NCCL ranks capture and replay a key of
             collectives and must leave the group (graphs destroyed
             first);
17. graphs  — the compiled step (``shadow_gnn_torch/train/graphs.py``),
             run after phase 7 for the flagship f32 and at bf16
             precision and after phase 11 for the GAT-5 f32 (each at its
             cuts, 1 epoch): an eager twin (``cuda_graphs=False``) and a
             graphed trainer from the same seed (the graphed one takes
             the eager one's feature table: GAT-5's label smoothening
             sums with atomics); TRAIN epoch 0 and its VALID pass, per
             step losses and predictions, the final parameters and Adam
             state, every kernel's launches, then ``predict_nodes`` /
             ``embed_nodes`` at every size (the warm-up, the capture,
             replays), held graphed against eager bit for bit
             (``GRAPH_TOLS`` where not, printed); every TRAIN and VALID
             step but the first of its key, and every serving bucket,
             must replay a graph.  Then in turns in the same call: the
             TRAIN step (eager, graphed, graphed, eager windows of 16
             steps, host clock), its device-busy share and host CUDA
             calls (torch.profiler), the request p50 by size, the
             capture seconds and the graph pool's MiB.  Every other
             phase's cached steps replay graphs too (``phase_train`` and
             ``phase_serve`` check that they did; the plain-version
             checks run eagerly, ``StepGraphs.paused``);
18. bfs     — after phase 2, the BFS kernel (``csrc/bfs_hops.cu``) against
             its plain version (the host loop) bit for bit on a chain (N
             - 1 levels), two components, a block with padding rows, a
             random block, a block whose frontier rows cancel (-1 and -3
             entries: a sum of 0 or less where an entry is > 0) and a
             dense block at N of ``BFS_SIZES`` (N % 4 != 0 among them), S
             = 1 and 2, on random blocks whose B * S passes the SM count
             (``BFS_WIDE``), on a chain of ``MAX_N`` nodes, and its
             refusal of N above ``MAX_N``; the two sides of
             ``launch_dims``' cluster rule timed on hub blocks at N of
             ``BFS_RULE_SIZES`` (208: one CTA a source, 408 and 907: a
             cluster, each beside the other); in ``power``, the cached TRAIN
             subgraphs (hops through the kernel) byte-equal to a cache
             built through the plain BFS, and the kernel timed on one
             cold TRAIN batch (B=64, N=208, S=1): the ``bfs_hops`` row of
             the ``kernels`` line, its launches those of the graphed
             twins below; in ``link`` on one DRNL batch (B=16, N=408, S
             = 2); both times beside the other side of the rule's to
             the log;
19. sampled graphs — the compiled sampled step, run at the end of
             ``power`` (the cold steps: TRAIN uncached), ``gat`` (the
             GAT-5's ``inference`` of VALID and TEST), ``ensemble`` (its
             TRAIN steps, PPR gathered and khop sampled in one graph,
             and requests of 1/8/64/128 ids) and ``link`` (its TRAIN
             step: ``ppr_st``, induction, DRNL, sort-25, Adam): an eager
             twin and a graphed trainer from one seed on the source
             phase's PPR tables, their passes (per-step losses and
             predictions, the epoch's overflow, every kernel's launches),
             parameters, Adam state and requests held bit for bit
             (``GRAPH_TOLS`` where not, printed), every sampled key
             replayed after its first call (in ``power`` and
             ``ensemble`` the first-epoch profile too, its stats equal);
             then steps (2 rounds of
             eager, graphed, graphed, eager windows of 8) and requests
             timed in turns, with the device-busy share and host CUDA
             calls a step; for the TRAIN steps (power, ensemble, link)
             the device time by stage (``_stage_split``: sample,
             membership, annotate, BFS, forward, backward, optimizer; a
             profiled eager window, kernels by launching range) and the
             graphed window's device time by kernel;
             ``SAMPLED_BUDGET_S`` for the four parts;
20. ring    — after the GAT-5's ``[infer]`` and ``[sampled gat]``, on
             [infer]'s prediction matrix, labels and products graph
             (every TRAIN label known; ``phase_ring``): (a) the
             single-card C&S (``postproc/cns.py:Propagation``, one CUDA
             graph of the 50 steps, cuSPARSE's SpMM captured) against
             its eager twin, ``norm_sym`` off and on; (b) in one NCCL
             rank of world 1 (``parallel/launch.py``) the ring C&S
             (``parallel/edgepart.py:make_outcome_correlation``, the
             whole loop one graph) against its eager twin and within
             ``TOL_CS`` of the single card, and the CLI's C&S
             (``main.main`` with a JSON ``--postproc_configs``, ``method:
             cs``, ``n_shards: 1``, three matrices on a run dir written
             here) at the single card's accuracies; (c) there too the
             smoothening ring (sym-2-concat and ppr on the flickr-scale
             graph, 89,250 x 500) within 1e-5 of max of the single
             card's ``smooth_signal_full``, and a ring product graphed
             against eager; (d) gloo world 4 on cuda:0, the ring C&S
             eager by design, within ``TOL_CS`` of the single card; (e)
             ``python -m torch.distributed.run --nproc_per_node 1 -m
             shadow_gnn_torch.main ... --distributed --partition dp``,
             one epoch of the flagship at the [parallel] cuts, which must
             join at the launcher's address over NCCL, replay its steps
             and finish.  Every graphed key's calls after its first
             replay; graphed = eager bit for bit where the order of sums
             is fixed, else within ``TOL_CS`` with the cause named
             (cuSPARSE; ``index_add_``'s atomics).  Prints ms a step,
             eager and graphed in turns, host CUDA calls a step, pools,
             peak memory, the phase's seconds (at most ``RING_BUDGET_S``)
             and the card.  With ``--parallel-nccl4`` the teardown key
             holds a ring shift, and the ring C&S and a smoothening
             product run at NCCL world 4 (``phase_ring_nccl4``), graphed
             against eager, with the NCCL kernels' overlap with the
             rest from torch.profiler;
21. profile (``--profile`` only) — torch.profiler over cached requests
             (flagship 1 and 256 ids, GAT 128 ids, the power-law flagship
             1 and 256, the ensemble 1 and 128) and over 5 TRAIN steps of
             each model, f32 and at bf16 precision (the power-law
             flagship's cached and cold steps, the ensemble's steps with
             their sampling): device-busy time
             per request or step (kernels only), its share of the
             unprofiled p50 request or median step, and the kernels and
             host operations that take the most time.

Standard output keeps each phase's summary lines; every line, the
per-case ones (kernel checks, timing rows, request sizes, the package's
own progress) too, goes to ``chiprun_out/chip_smoke.log`` beside the
script.  The line before the closing ones gives standard output's
size.  The last three lines are the card's name and power limit
(nvidia-smi), one JSON object describing every kernel, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository around it, the script exits non-zero and prints no result.
"""
import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM data sheet, f32 outside the tensor cores
SERVE_SIZES = (1, 8, 64, 256)
EMBED_SIZE = 64
REPEATS = 20
WARMUP = 5
TOL_PROBS = 1e-4                # abs, on probabilities and unit embeddings
# C&S on the card against the CPU: 50 steps of y <- 0.8 A y + 0.2 y0
# clamped to [0, 1]; cuSPARSE and the CPU product sum each row in other
# orders, and the symmetric scaling multiplies by sqrt(in_deg) around
# the product (abs, on the propagated matrix)
TOL_CS = 1e-4
# At bf16 precision every linear rounds its operands to bf16: a last-bit
# difference between the kernel's and the plain version's sums (or the
# dense path's) flips some operand's rounding, which moves it by 2^-8 of
# itself and its products by up to that; B3b's dv rounds P = e / D, whose
# D the two versions sum in other orders (``phase_kernels_gat_bf16``
# counts such roundings).  End-to-end agreement there is held at
# (probabilities abs, step loss rel, gradients of their max), the last
# one bf16 step of the largest gradient:
TOLS_BF16 = (1e-3, 1e-4, 2.0 ** -8)
TRAIN_NODES, VALID_NODES, TEST_NODES = 4096, 1024, 4096
EPOCHS = 2
DROPEDGE = 0.05                 # configs/flickr_sage_3_ppr.yml
GAT_SIZES = (1, 8, 64, 128)
GAT_TRAIN, GAT_VALID, GAT_TEST = 4096, 1024, 2048
GAT_DROPEDGE = 0.1              # configs/products_gat_5_ppr_leaderboard.yml
KINKED_ACTS = ("relu", "prelu", "prelu+", "leakyrelu")   # derivative jumps at 0
COLD_STEPS = 10                 # timed TRAIN steps of the power-law and ensemble phases
ENSEMBLE_WIDTHS = (104, 112)    # n_pad of the PPR-100 and the khop 2 x 10 branches
LINK_TRAIN_POS = 20_480         # TRAIN positives, edges of the collab-shape message graph
LINK_K_TAB = 400                # ppr_st k 200: the race's 2k pool
LINK_N_PAD = 408                # 2 targets x (k + 1), rounded up to 8
LINK_CHECK_TRIES = 4            # batches tried for a card-vs-CPU step without rank swaps


LOG_NAME = os.path.join("chiprun_out", "chip_smoke.log")
STDOUT_LIMIT = 24_000           # bytes of standard output the caller gets back
_OUT = None                     # the _Stdout that main installs


class _Stdout:
    """``sys.stdout`` while ``main`` runs.  Every line goes to the full
    log (``LOG_NAME`` beside the script); the card's standard output
    keeps the script's own summary lines, and not the lines the
    package's modules print (PPR, cache and epoch progress, the profile)
    nor those of ``_detail``.  ``bytes`` counts what standard output got."""

    def __init__(self, real, log):
        self.real, self.log, self.bytes = real, log, 0

    def write(self, s):
        self.log.write(s)
        if sys._getframe(1).f_globals.get("__name__", "").startswith(
                "shadow_gnn_torch"):
            return len(s)
        self.bytes += len(s.encode())
        return self.real.write(s)

    def flush(self):
        self.log.flush()
        self.real.flush()

    def __getattr__(self, name):
        return getattr(self.real, name)


def _detail(*args):
    """A per-case line (a kernel check, a timing row, a request size):
    into the full log only, once ``main`` has installed it."""
    if _OUT is None:
        print(*args)
    else:
        print(*args, file=_OUT.log)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _time_ms(fn, rounds=7, iters=20, warmup=3):
    """Device time of one call of ``fn``: ``iters`` back-to-back calls are
    captured in a CUDA graph (so the host's dispatch, which exceeds the
    smaller kernels' run time, is not timed), and the median over
    ``rounds`` replays, from CUDA events, is divided by ``iters``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return _median(times)


class _Swap:
    """Within the block each (module, name) is bound to a replacement."""

    def __init__(self, *swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [getattr(m, name) for m, name, _ in self.swaps]
        for m, name, fn in self.swaps:
            setattr(m, name, fn)

    def __exit__(self, *exc):
        for (m, name, _), fn in zip(self.swaps, self.saved):
            setattr(m, name, fn)


class _Launches:
    """One kernel level's launch count, read and set as ``.launches``: the
    counter ``attr`` of the wrapper ``fn`` (``launches`` at the f32 level,
    ``launches_bf16`` at the bf16 levels), named ``name``."""

    def __init__(self, fn, attr, name):
        self.fn, self.attr, self.__name__ = fn, attr, name

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.fn, self.attr, value)


def _bf16_counts():
    """The launch counts of B1c (forward, transposed) and B2b, B3b."""
    from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_t
    return [_Launches(fn, "launches_bf16", f"{fn.__name__}_bf16")
            for fn in (packed_spmm, packed_spmm_t, gat_attention, gat_attention_bwd)]


def _plain_versions(rounded=False):
    """The model aggregates through the plain PyTorch versions instead of
    the kernels: ``packed_spmm_plain`` and ``gat_attention_plain`` with
    autograd's backward.  ``rounded`` (a model at the bf16 levels): the
    plain forwards and the plain backwards, which round their operands as
    the backward kernels do and autograd would not, take the kernels'
    place inside the port's autograd functions."""
    from shadow_gnn_torch.nn import layers, model
    from shadow_gnn_torch.ops import gat, packed
    if rounded:
        return _Swap((packed, "_aggregate", packed.packed_spmm_plain),
                     (gat, "_forward", gat.gat_attention_plain),
                     (gat, "gat_attention_bwd", gat.gat_attention_bwd_plain))
    return _Swap((model, "packed_spmm", packed.packed_spmm_plain),
                 (layers, "gat_attention", gat.gat_attention_plain))


def _rounded(tr):
    """Whether the trainer's model runs the kernels' bf16 levels (at bf16
    or TF32 precision, or a bf16 compute dtype)."""
    cfg = tr.model_cfg
    return ("bfloat16" in (cfg.matmul_precision, cfg.compute_dtype)
            or cfg.matmul_precision == "tensorfloat32")


def _plain_backwards():
    """The forward kernels stay; the backward kernels (``packed_spmm_t``,
    ``gat_attention_bwd``) give way to their plain versions."""
    from shadow_gnn_torch.ops import gat, packed
    return _Swap(
        (gat, "gat_attention_bwd", gat.gat_attention_bwd_plain),
        (packed, "packed_spmm_t", lambda bits, g, norm, dropedge, seed, bf16:
            packed.packed_spmm_plain(bits, g, norm, dropedge, seed, True, bf16)))


def phase_build():
    from shadow_gnn_torch.native import get_lib
    from shadow_gnn_torch.ops import build
    t0 = time.perf_counter()
    logs = build.build()
    t_cuda = time.perf_counter() - t0
    for name, log in logs.items():
        flags = build.NVCC_FLAGS + build.KERNEL_FLAGS.get(name, [])
        _detail(f"[build] {name}: nvcc {' '.join(flags)}\n{log.strip()}")
    t0 = time.perf_counter()
    get_lib()
    print(f"[build] CUDA kernels {t_cuda:.2f}s, native PPR push "
          f"{time.perf_counter() - t0:.2f}s")


# (N, B, density, directions) of the packed kernels' checks: the small
# blocks, the cached PPR size at the serving batch, a dense block, the
# largest N the transposed kernel takes, and a forward beyond it (its
# tile built in sub-tiles); ``_packed_blocks`` adds an empty row, and
# makes the N=208 blocks undirected like the cached ones
PACKED_CASES = ((24, 64, 0.05, (False, True)), (37, 64, 0.05, (False, True)),
                (208, 256, 0.05, (False, True)), (208, 16, 0.3, (False, True)),
                (3592, 2, 0.05, (False, True)), (6500, 1, 0.05, (False,)))
PACKED_F = (37, 256, 500)


def _packed_blocks(gen):
    """(N, B, directions, bits, the F of its checks) of every case of
    ``PACKED_CASES``; the largest two at F=37 only."""
    import torch
    from shadow_gnn_torch.sampling.cache import pack_bits
    for n, b, dens, dirs in PACKED_CASES:
        adj = (torch.rand(b, n, n, device="cuda", generator=gen) < dens).float()
        if n == 208:                           # undirected, like cached blocks
            adj = torch.maximum(adj, adj.transpose(1, 2))
        adj[:, n // 3] = 0.0                   # an empty row
        yield n, b, dirs, pack_bits(adj), PACKED_F if n < 1000 else PACKED_F[:1]
        del adj


def _print_packed_launches():
    """The structure pass and gather shape of the packed kernels at the
    main path's shapes, and the largest N each direction takes."""
    from shadow_gnn_torch.ops.packed import MAX_N, launch_dims
    for b, f in ((8, 500), (8, 256), (64, 500), (64, 256), (256, 500)):
        d = launch_dims(b, 208, f)
        _detail(f"[kernels] packed launch B={b} N=208 F={f}: {d.grid} CTAs in "
                f"clusters of {d.cluster}, {d.threads} threads, {d.tile} lines a "
                f"CTA ({d.sub} a bitmap), features in {d.fsplit} split(s) of "
                f"{d.per} chunks of 128, {d.smem} B shared, float4 {d.vec}")
    for t in (False, True):
        lo, hi = 1, MAX_N
        while lo < hi:
            mid = (lo + hi + 1) // 2
            try:
                launch_dims(1, mid, 8, t)
                lo = mid
            except ValueError:
                hi = mid - 1
        _detail(f"[kernels] {'packed_spmm_t' if t else 'packed_spmm'} takes N up "
                f"to {lo}")


def phase_kernels():
    """Every kernel against its plain version on the card; returns the
    worst max |kernel - plain| of each kernel, over every norm (and of
    each direction in the ``sym`` and ``gin`` norms, as
    ``packed_spmm_sym`` ...)."""
    import torch
    from shadow_gnn_torch.ops.packed import (packed_spmm, packed_spmm_plain,
                                             packed_spmm_t)
    _print_packed_launches()
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"packed_spmm": (0.0, 0.0), "packed_spmm_t": (0.0, 0.0)}
    for n, b, dirs, bits, fs in _packed_blocks(gen):
        for f in fs:
            x = torch.randn(b, n, f, device="cuda", generator=gen)
            for norm in ("none", "rw", "sym", "gin"):
                for t in dirs:
                    for p in (0.0, DROPEDGE, 0.5):
                        name = "packed_spmm_t" if t else "packed_spmm"
                        seed = 1000 * n + f
                        fn = packed_spmm_t if t else packed_spmm
                        got = fn(bits, x, norm, p, seed)
                        torch.cuda.synchronize()
                        want = packed_spmm_plain(bits, x, norm, p, seed, transpose=t)
                        torch.cuda.synchronize()
                        err = (got - want).abs().max().item()
                        rel = err / max(want.abs().max().item(), 1e-30)
                        _detail(f"[kernels] {name:13s} B={b} N={n} F={f} {norm:4s} "
                                f"p={p:<4} max abs {err:.3e} rel {rel:.3e}")
                        if not rel <= 1e-4:
                            raise AssertionError(f"{name} {norm} N={n} F={f} p={p}: "
                                                 f"rel error {rel} > 1e-4")
                        keys = [name] + ([f"{name}_{norm}"]
                                         if norm in ("sym", "gin") else [])
                        for key in keys:
                            w_abs, w_rel = worst.get(key, (0.0, 0.0))
                            worst[key] = (max(w_abs, err), max(w_rel, rel))
        del bits
    # beyond the transposed kernel's limit it raises
    x = torch.zeros(1, 3593, 8, device="cuda")
    try:
        packed_spmm_t(torch.zeros(1, 3593, 450, dtype=torch.uint8, device="cuda"),
                      x, "rw")
    except ValueError:
        pass
    else:
        raise AssertionError("packed_spmm_t took N=3593 beyond its limit")
    for name, (w_abs, w_rel) in worst.items():
        print(f"[kernels] {name} worst abs {w_abs:.3e} rel {w_rel:.3e}")
    return {name: w_abs for name, (w_abs, _) in worst.items()}


def _gat_cases():
    """(N, B) of the GAT kernels' checks: small blocks, the products shape,
    the papers GAT-3 shape, and the largest N the kernels take."""
    from shadow_gnn_torch.ops.gat import MAX_N
    return ((16, 32), (152, 128), (408, 16), (MAX_N, 2))


def _gat_case(b, n, h, dh, drop, gen):
    """Random attention operands on the card with the edge-case rows: an
    empty row, a row whose kept entries were all dropped, a row whose max
    lies on a dropped edge, padded tail rows (3 rows and columns of
    zeros)."""
    import torch
    adj = (torch.rand(b, n, n, device="cuda", generator=gen) < 0.05).float()
    adj = torch.maximum(adj, adj.transpose(1, 2))
    adj = torch.maximum(adj, torch.eye(n, device="cuda"))
    adj[:, n - 3:] = 0.0
    adj[:, :, n - 3:] = 0.0
    adj[:, n // 3] = 0.0                                   # no structural edge
    keep = (torch.rand(b, n, n, device="cuda", generator=gen) >= drop).float()
    adj_norm = adj * keep
    adj_norm[:, n // 2] = 0.0                              # every entry dropped
    a_s = 2.0 * torch.randn(b, h, n, device="cuda", generator=gen)
    a_n = 2.0 * torch.randn(b, h, n, device="cuda", generator=gen)
    i4 = n // 4                                            # max on a dropped edge
    adj[:, i4, 0] = 1.0
    adj_norm[:, i4, 0] = 0.0
    adj_norm[:, i4, i4] = adj[:, i4, i4]
    a_n[:, :, 0] = 8.0
    v = torch.randn(b, n, h, dh, device="cuda", generator=gen)
    g = torch.randn(b, n, h, dh, device="cuda", generator=gen)
    return a_s, a_n, v, adj_norm, adj, g


def phase_kernels_gat():
    """B2 and B3 against their plain versions on random blocks with the
    edge-case rows; returns the worst max |kernel - plain| of each."""
    import torch
    from shadow_gnn_torch.ops.gat import (gat_attention, gat_attention_bwd,
                                          gat_attention_bwd_plain,
                                          gat_attention_plain)
    from shadow_gnn_torch.ops.gat import launch_dims, occupancy
    for shape in ((128, 152, 4, 128), (64, 408, 4, 200)):
        _detail(f"[kernels] gat launch at (B, N, H, dh) = {shape}: "
                f"{launch_dims(*shape)}; CTAs an SM (forward, backward) "
                f"{occupancy(*shape)}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"gat_attention": 0.0, "gat_attention_bwd": 0.0}
    n_cases = 0
    for n, b in _gat_cases():
        for h in (1, 4):
            for dh in (8, 128, 200):
                for drop in (0.0, 0.1):
                    a_s, a_n, v, adj_norm, adj, g = _gat_case(b, n, h, dh, drop, gen)
                    with torch.no_grad():
                        got = gat_attention(a_s, a_n, v, adj_norm, adj)
                    torch.cuda.synchronize()
                    want = gat_attention_plain(a_s, a_n, v, adj_norm, adj)
                    err = (got - want).abs().max().item()
                    rel = err / max(want.abs().max().item(), 1e-30)
                    got_b = gat_attention_bwd(a_s, a_n, v, adj_norm, adj, want, g)
                    torch.cuda.synchronize()
                    want_b = gat_attention_bwd_plain(a_s, a_n, v, adj_norm, adj,
                                                     want, g)
                    # d att_self is 0 up to rounding: held at an absolute
                    # tolerance on the scale of the column sums
                    scale = max(want_b[1].abs().max().item(),
                                want_b[2].abs().max().item(), 1e-30)
                    errs_b = [(x - y).abs().max().item()
                              for x, y in zip(got_b, want_b)]
                    rel_b = [errs_b[0] / scale,
                             errs_b[1] / max(want_b[1].abs().max().item(), 1e-30),
                             errs_b[2] / max(want_b[2].abs().max().item(), 1e-30)]
                    _detail(f"[kernels] gat B={b} N={n} H={h} dh={dh} drop={drop}: "
                            f"forward max abs {err:.3e} rel {rel:.3e}; backward "
                            f"das {errs_b[0]:.3e} ({rel_b[0]:.2e} of scale) dan "
                            f"{errs_b[1]:.3e} ({rel_b[1]:.2e}) dv {errs_b[2]:.3e} "
                            f"({rel_b[2]:.2e})")
                    if not (rel <= 1e-4 and max(rel_b) <= 1e-4):
                        raise AssertionError(f"gat kernels N={n} H={h} dh={dh} "
                                             f"drop={drop}: {rel}, {rel_b} > 1e-4")
                    zero_rows = got[:, [n // 3, n // 2, n - 1]]
                    if bool(zero_rows.abs().max() != 0):
                        raise AssertionError("an empty, all-dropped or padded "
                                             "row did not aggregate to 0")
                    worst["gat_attention"] = max(worst["gat_attention"], err)
                    worst["gat_attention_bwd"] = max(worst["gat_attention_bwd"],
                                                     max(errs_b))
                    n_cases += 1
    # beyond the kernels' limits they raise: dh 264, and N one past the
    # largest the backward's bitmaps take
    n_max = _gat_cases()[-1][0]
    for b, n, dh in ((2, 16, 264), (1, n_max + 1, 8)):
        a_s, a_n, v, adj_norm, adj, g = _gat_case(b, n, 1, dh, 0.0, gen)
        for call in (lambda: gat_attention(a_s, a_n, v, adj_norm, adj),
                     lambda: gat_attention_bwd(a_s, a_n, v, adj_norm, adj, v, g)):
            try:
                call()
            except ValueError:
                pass
            else:
                raise AssertionError(f"gat kernels took N={n} dh={dh} beyond "
                                     "their limits")
    print(f"[kernels] gat worst over {n_cases} cases: forward abs "
          f"{worst['gat_attention']:.3e}, backward abs "
          f"{worst['gat_attention_bwd']:.3e}")
    return worst


def _rel_err(got, want):
    """(max |got - want|, that over max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def phase_precision():
    """The bf16-precision product (``ops/precision.py``) on the card: a
    cuBLAS bf16 GEMM with f32 output, forward and both gradients, against
    the f32 product of the rounded operands (its CPU form), at the
    flagship's and the GAT's linear shapes and the dense aggregation's."""
    import torch
    from shadow_gnn_torch.ops.precision import bf16_matmul, round_bf16
    gen = torch.Generator(device="cuda").manual_seed(6)
    for a_shape, b_shape in (((64 * 208, 500), (500, 256)),
                             ((128 * 152, 512), (512, 512)),
                             ((64, 208, 208), (64, 208, 256))):
        a = torch.randn(a_shape, device="cuda", generator=gen).requires_grad_()
        b = torch.randn(b_shape, device="cuda", generator=gen).requires_grad_()
        g = torch.randn(a_shape[:-1] + b_shape[-1:], device="cuda", generator=gen)
        got = torch.autograd.grad(bf16_matmul(a, b), (a, b), g)
        out = bf16_matmul(a, b).detach()
        ar, br, gr = (round_bf16(t.detach()) for t in (a, b, g))
        want = (torch.matmul(ar, br), torch.matmul(gr, br.transpose(-1, -2)),
                torch.matmul(ar.transpose(-1, -2), gr))
        rels = [_rel_err(x, y)[1] for x, y in zip((out,) + got, want)]
        _detail(f"[precision] bf16_matmul {tuple(a_shape)} @ {tuple(b_shape)}: "
                f"out, da, db rel {', '.join(f'{r:.2e}' for r in rels)} against the "
                f"f32 product of the rounded operands")
        if not max(rels) <= 1e-5:
            raise AssertionError(f"bf16_matmul differs from the rounded f32 "
                                 f"product by {max(rels)}")


def phase_kernels_bf16():
    """B1c, both directions, against ``packed_spmm_plain(bf16=True)``: all
    norms, dropedge 0/0.05/0.5, on the blocks and F of ``PACKED_CASES``.
    The kernel's rounded weights are read off its product with the
    identity (exact: one nonzero term per sum); a weight whose bf16
    rounding differs from the plain block's is a flip, counted and bounded
    (1e-3 of the entries); the product is held at 1e-4 of max against the
    kernel's own weights, and against the plain version wherever no weight
    flipped.  Returns the worst max |kernel - plain| of each direction."""
    import torch
    from shadow_gnn_torch.ops.packed import (NORMS, packed_spmm,
                                             packed_spmm_plain, packed_spmm_t)
    from shadow_gnn_torch.ops.precision import round_bf16
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {"packed_spmm_bf16": 0.0, "packed_spmm_t_bf16": 0.0}
    flips = beyond = entries = 0
    for n, b, dirs, bits, fs in _packed_blocks(gen):
        eye = torch.eye(n, device="cuda").expand(b, n, n).contiguous()
        xs = {f: torch.randn(b, n, f, device="cuda", generator=gen) for f in fs}
        for norm in NORMS:
            for p in (0.0, DROPEDGE, 0.5):
                seed = 1000 * n + 7
                for t in dirs:
                    name = "packed_spmm_t_bf16" if t else "packed_spmm_bf16"
                    fn = packed_spmm_t if t else packed_spmm
                    w_k = fn(bits, eye, norm, p, seed, bf16=True)
                    w_p = packed_spmm_plain(bits, eye, norm, p, seed, t, True)
                    n_flip = int((w_k != w_p).sum())
                    nnz = int((w_p != 0).sum())
                    del w_p
                    for f, x in xs.items():
                        got = fn(bits, x, norm, p, seed, bf16=True)
                        want = packed_spmm_plain(bits, x, norm, p, seed, t, True)
                        own = torch.bmm(w_k, round_bf16(x))
                        torch.cuda.synchronize()
                        err, rel = _rel_err(got, want)
                        _, rel_own = _rel_err(got, own)
                        n_beyond = int(((got - want).abs()
                                        > 1e-5 * want.abs().max()).sum())
                        _detail(f"[kernels] {name:18s} B={b} N={n} F={f} {norm:4s} "
                                f"p={p:<4} max abs {err:.3e} rel {rel:.3e} (own "
                                f"weights {rel_own:.3e}); flipped weights {n_flip} "
                                f"of {nnz}; beyond 1e-5 of max {n_beyond}")
                        if not (rel_own <= 1e-4 and n_flip <= 1e-3 * nnz
                                and (n_flip or rel <= 1e-4)):
                            raise AssertionError(
                                f"{name} {norm} N={n} F={f} p={p}: rel {rel}, own "
                                f"{rel_own}, {n_flip} flips of {nnz}")
                        worst[name] = max(worst[name], err)
                        flips, beyond, entries = (flips + n_flip, beyond + n_beyond,
                                                  entries + got.numel())
                    del w_k
        del bits, eye, xs
    print(f"[kernels] B1c worst abs {worst}; flipped weights {flips}, entries "
          f"beyond 1e-5 of max {beyond} of {entries}")
    return worst


def _flip_size(p):
    """Where the bf16 rounding of ``p`` (f32) would change if ``p`` moved by
    2^-18 of itself, as a sum taken in another order can move it: the size
    of that change (one bf16 step); 0 elsewhere."""
    from shadow_gnn_torch.ops.precision import round_bf16
    w = 2.0 ** -18
    return (round_bf16(p * (1 + w)) - round_bf16(p * (1 - w))).abs()


def _bf16_step(x):
    """The spacing of bf16 values at each nonzero entry of ``x``."""
    import torch
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8) * (x != 0)


def phase_kernels_gat_bf16():
    """B2b and B3b at both levels (``bf16``; ``bf16`` + ``bf16_scores``)
    with f32 and bf16 values, against their plain versions on the cases
    of :func:`phase_kernels_gat`.  Forward, d att_self and d att_neigh at
    1e-4 of max (as the f32 level).  dv rounds P = e / D, whose
    denominator the kernel and the plain version sum in other orders: it
    is held at 1e-4 of max plus, per entry, the sum of |g| over the P
    whose rounding such a move would flip (counted), plus one bf16 step
    of dv itself for bf16 values (dv comes back in their dtype).  Returns
    the worst max |kernel - plain| of each direction."""
    import torch
    from shadow_gnn_torch.ops import gat
    from shadow_gnn_torch.ops.precision import round_bf16
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = {"gat_attention_bf16": 0.0, "gat_attention_bwd_bf16": 0.0}
    n_cases = flips = 0
    for n, b in _gat_cases():
        for h in (1, 4):
            for dh in (8, 128, 200):
                for drop in (0.0, 0.1):
                    case = _gat_case(b, n, h, dh, drop, gen)
                    for level, vdt in ((1, torch.float32), (2, torch.float32),
                                       (1, torch.bfloat16), (2, torch.bfloat16)):
                        a_s, a_n, v, adj_norm, adj, g = case
                        v = v.to(vdt)
                        kw = dict(bf16=True, bf16_scores=level == 2)
                        with torch.no_grad():
                            got = gat.gat_attention(a_s, a_n, v, adj_norm, adj, **kw)
                        want = gat.gat_attention_plain(a_s, a_n, v, adj_norm, adj, **kw)
                        got_b = gat.gat_attention_bwd(a_s, a_n, v, adj_norm, adj,
                                                      want, g, **kw)
                        want_b = gat.gat_attention_bwd_plain(a_s, a_n, v, adj_norm,
                                                             adj, want, g, **kw)
                        torch.cuda.synchronize()
                        err, rel = _rel_err(got, want)
                        scale = max(want_b[1].abs().max().item(),
                                    want_b[2].float().abs().max().item(), 1e-30)
                        das_err = (got_b[0] - want_b[0]).abs().max().item()
                        dan_err, dan_rel = _rel_err(got_b[1], want_b[1])
                        e, dn = gat._scores(a_s, a_n, adj_norm, adj, level == 2)
                        size = _flip_size(e.float() / dn)
                        n_flip = int((size > 0).sum())
                        slack = torch.einsum("bhij,bihd->bjhd", size,
                                             round_bf16(g).abs())
                        dv_k, dv_p = got_b[2].float(), want_b[2].float()
                        if vdt == torch.bfloat16:
                            slack = slack + _bf16_step(dv_p)
                        dv_diff = (dv_k - dv_p).abs()
                        dv_max = dv_p.abs().max().item()
                        dv_out = int((dv_diff > 1e-4 * dv_max + slack).sum())
                        dv_beyond = int((dv_diff > 1e-4 * dv_max).sum())
                        _detail(f"[kernels] gat bf16 level {level} v {str(vdt)[6:]} "
                                f"B={b} N={n} H={h} dh={dh} drop={drop}: forward rel "
                                f"{rel:.3e}; das {das_err / scale:.2e} of scale, dan "
                                f"{dan_rel:.2e}, dv max abs {dv_diff.max().item():.3e}"
                                f" ({dv_beyond} beyond 1e-4 of max, {dv_out} beyond "
                                f"that plus the flip slack; {n_flip} P entries whose "
                                f"rounding can flip)")
                        if not (rel <= 1e-4 and das_err / scale <= 1e-4
                                and dan_rel <= 1e-4 and dv_out == 0):
                            raise AssertionError(f"gat bf16 kernels level {level} "
                                                 f"N={n} H={h} dh={dh} drop={drop}")
                        if bool(got[:, [n // 3, n // 2, n - 1]].abs().max() != 0):
                            raise AssertionError("an empty, all-dropped or padded "
                                                 "row did not aggregate to 0")
                        worst["gat_attention_bf16"] = max(worst["gat_attention_bf16"],
                                                          err)
                        worst["gat_attention_bwd_bf16"] = max(
                            worst["gat_attention_bwd_bf16"], das_err, dan_err,
                            dv_diff.max().item())
                        n_cases += 1
                        flips += n_flip
    print(f"[kernels] gat bf16 worst over {n_cases} cases: {worst}; P entries "
          f"whose rounding can flip {flips}")
    return worst


def _cut_splits(tr, cuts):
    """Cut each mode's node set to its first ``keep`` nodes once the
    trainer is built: the preprocessing saw every node of every split
    (every TRAIN label of ``use_label``); the PPR tables, the caches and
    the epochs see the cut sets."""
    for mode, keep in cuts:
        tr.entity_set[mode] = tr.entity_set[mode][:keep]


def _synthetic_graph(tag, **kw):
    """A synthetic graph, made once for the trainers of one model."""
    from shadow_gnn_torch.data import make_synthetic_dataset
    t0 = time.perf_counter()
    g = make_synthetic_dataset(**kw)
    print(f"{tag} synthetic graph {time.perf_counter() - t0:.1f}s")
    return g


def _own_splits(g):
    """``g`` with its own copy of the node sets, which ``_cut_splits``
    cuts in place."""
    import dataclasses
    return dataclasses.replace(g, node_set=dict(g.node_set))


def _flickr_graph():
    return _synthetic_graph("[serve]", num_nodes=89_250, avg_deg=10.0,
                            num_feat=500, num_classes=7, seed=0, power_law=False)


def _products_graph():
    return _synthetic_graph("[gat]", num_nodes=250_000, avg_deg=15, num_feat=100,
                            num_classes=47, seed=0, power_law=False)


def _flagship_trainer(g, epochs=EPOCHS, arch=None, sampler=None, tag="[serve]",
                      name="flickr_synth", data_dir="", use_device_ppr=None,
                      cuda_graphs=True, **precision):
    """The flagship SAGE-3 trainer on the graph ``g``, ``epochs`` epochs;
    ``arch``: architecture keys that replace the yml's, ``sampler``: a
    sampler list that replaces its; ``name``, ``data_dir``: the dataset
    and the dir of its PPR cache (none when empty); ``use_device_ppr``,
    ``cuda_graphs`` and ``precision`` (``matmul_precision`` /
    ``compute_dtype`` / ``feat_dtype``): the Trainer's arguments."""
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer

    t0 = time.perf_counter()
    tr = Trainer(name, data_dir, _own_splits(g),
                 parse_config(_flagship_cfg(epochs, arch, sampler)), seed=0,
                 device="cuda", packed_adj=True, use_device_ppr=use_device_ppr,
                 cuda_graphs=cuda_graphs, **precision)
    _cut_splits(tr, ((TRAIN, TRAIN_NODES), (VALID, VALID_NODES), (TEST, TEST_NODES)))
    torch.cuda.synchronize()
    _detail(f"{tag} trainer {time.perf_counter() - t0:.1f}s {precision or ''}"
            f"{arch or ''}")
    return tr


def _flagship_cfg(epochs=EPOCHS, arch=None, sampler=None):
    """configs/flickr_sage_3_ppr.yml as a dict, ``end`` set to
    ``epochs``; ``arch`` keys replace the architecture's, ``sampler`` the
    sampler list."""
    # written out (the card machine may lack a yml parser); the synthetic
    # graph has no inductive split
    cfg = {
        "data": {"to_undirected": True, "transductive": True},
        "architecture": {"dim": 256, "aggr": "sage", "loss": "softmax",
                         "num_layers": 3, "act": "relu", "use_label": "none",
                         "feature_smoothen": "none", "label_smoothen": "none",
                         "feature_augment": "hops", "residue": "none",
                         "pooling": "center"},
        "hyperparameter": {"end": epochs, "lr": 5e-4, "dropout": 0.45,
                           "dropedge": DROPEDGE, "batch_size": 64},
        "sampler": [{"method": "ppr", "phase": "train", "k": [200],
                     "epsilon": [1e-6]}],
    }
    cfg["architecture"].update(arch or {})
    if sampler is not None:
        cfg["sampler"] = sampler
    return cfg


def _gat_trainer(g, epochs=EPOCHS, retrain_dir=None, data_dir="", cuda_graphs=True,
                 **precision):
    """The products GAT-5 leaderboard model at full width on the
    products-width synthetic graph ``g``; the preprocessing (ppr label
    smoothening of every TRAIN label) runs on the card while the trainer
    is built, before the splits are cut.  ``retrain_dir``: the run dir
    whose checkpoint the trainer starts from; ``data_dir``: the dir of
    its PPR cache (none when empty).  ``cuda_graphs`` and ``precision``
    (``matmul_precision`` / ``compute_dtype`` / ``feat_dtype``): the
    Trainer's arguments."""
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer
    t0 = time.perf_counter()
    tr = Trainer("products_synth", data_dir, _own_splits(g),
                 parse_config(_gat_cfg(epochs, retrain_dir)), seed=0, device="cuda",
                 cuda_graphs=cuda_graphs, **precision)
    _cut_splits(tr, ((TRAIN, GAT_TRAIN), (VALID, GAT_VALID), (TEST, GAT_TEST)))
    torch.cuda.synchronize()
    log = tr.preproc_log
    _detail(f"[gat] {precision} trainer {time.perf_counter() - t0:.1f}s; "
            f"preprocessing: label smoothening {log['label_smoothen_s']:.2f}s, "
            f"{log['label_smoothen_steps']} iterations; features "
            f"{tr.dim_feat_smooth} + label inputs {tr.dim_label_smooth}")
    if not 1 < log["label_smoothen_steps"] < 100:
        raise AssertionError("the ppr label smoothening did not converge "
                             "within its 100 iterations")
    if tr.model_cfg.mulhead != 4 or not tr.branches[0]["cfg"][TRAIN].add_self_edge:
        raise AssertionError("the GAT-5 trainer lost its heads or self edges")
    return tr


def _gat_cfg(epochs=EPOCHS, retrain_dir=None):
    """configs/products_gat_5_ppr_leaderboard.yml as a dict, ``end`` set
    to ``epochs``."""
    cfg = {
        "data": {"transductive": True},
        "architecture": {"dim": 512, "aggr": "gat", "heads": 4, "loss": "softmax",
                         "num_layers": 5, "act": "prelu", "feature_augment": "none",
                         "feature_smoothen": "none", "use_label": "no_valid",
                         "label_smoothen": "ppr--concat-0.8", "residue": "max",
                         "pooling": "max"},
        "hyperparameter": {"end": epochs, "lr": 0.001, "dropout": 0.4,
                           "dropedge": GAT_DROPEDGE, "batch_size": 128},
        "sampler": [{"method": "full", "phase": "preprocess"},
                    {"method": "ppr", "phase": "train", "k": [150],
                     "epsilon": [1e-5]}],
    }
    if retrain_dir is not None:
        cfg["hyperparameter"]["retrain_dir"] = retrain_dir
    return cfg


def _check_probs(p, s, num_classes):
    import numpy as np
    if not (p.shape == (s, num_classes) and np.isfinite(p).all()
            and np.allclose(p.sum(1), 1.0, atol=1e-5)):
        raise AssertionError(f"bad probabilities for a {s}-id request")


def _check_emb(e, s, dim, branches=1):
    import numpy as np
    if not (len(e) == branches and all(
            x.shape == (s, dim) and np.isfinite(x).all()
            and np.allclose(np.linalg.norm(x, axis=1), 1.0, atol=1e-5) for x in e)):
        raise AssertionError(f"bad embeddings for a {s}-id request")


def _per_pass(tr):
    """Aggregation kernel launches of one forward (or backward): one per
    conv layer of each ensemble branch."""
    return tr.model_cfg.num_layers * tr.num_ensemble


def _max_diff(fn, reqs, want):
    import numpy as np
    return max(float(np.abs(np.asarray(fn(reqs[s][0])) - want[s]).max())
               for s in want)


def _tols(tr):
    """(probabilities abs, step loss rel, gradients of their max) for the
    trainer's model: ``TOLS_BF16`` at the bf16 levels."""
    return TOLS_BF16 if _rounded(tr) else (TOL_PROBS, 1e-5, 1e-4)


def phase_serve(tr, sizes, fwd, tag):
    """Cached requests of every size through the kernel ``fwd``, with its
    launches counted per request, checked, and held against the plain
    versions.  Returns (requests, p50 ms per size)."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TEST

    secs = tr.prepare_serving(TEST)
    n_layers = _per_pass(tr)
    _detail(f"{tag} PPR tables {secs['ppr_s']:.2f}s, cache build "
            f"{secs['cache_s']:.2f}s ({len(tr.entity_set[TEST])} roots; "
            + "; ".join(f"branch {i} {br['cfg'][TEST].method} n_pad "
                        f"{br['cfg'][TEST].n_pad}, induction {br['cfg'][TEST].induction}"
                        f" deg_cap {br['cfg'][TEST].deg_cap} hub_slots "
                        f"{br['cfg'][TEST].hub_slots}"
                        for i, br in enumerate(tr.branches)) + ")")
    rng = np.random.default_rng(0)
    test_ids = np.asarray(tr.entity_set[TEST])
    reqs = {s: [rng.choice(test_ids, s, replace=False) for _ in range(REPEATS)]
            for s in sizes + (EMBED_SIZE,)}
    for s in sizes:                                      # warm-up, every size
        for ids in reqs[s][:WARMUP]:
            tr.predict_nodes(ids, TEST)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts at 0 just before, read just after
    fwd.launches = 0
    lat, probs, n_req = {}, {}, 0
    for s in sizes:
        lat[s] = []
        for ids in reqs[s]:
            before = fwd.launches
            t0 = time.perf_counter()
            p = tr.predict_nodes(ids, TEST)
            lat[s].append((time.perf_counter() - t0) * 1e3)
            n_req += 1
            if fwd.launches != before + n_layers:
                raise AssertionError(f"a {s}-id request launched {fwd.__name__} "
                                     f"{fwd.launches - before} times")
            _check_probs(p, s, tr.num_classes)
            probs.setdefault(s, p)
    emb = None
    for ids in reqs[EMBED_SIZE][:WARMUP]:
        before = fwd.launches
        e = tr.embed_nodes(ids, TEST)
        n_req += 1
        if fwd.launches != before + n_layers:
            raise AssertionError(f"an embed_nodes request did not launch "
                                 f"{fwd.__name__} {n_layers} times")
        _check_emb(e, EMBED_SIZE, tr.model_cfg.dim, tr.num_ensemble)
        emb = e[0] if emb is None else emb
    launches = fwd.launches
    peak = torch.cuda.max_memory_allocated()

    for s in sizes:
        _detail(f"{tag} predict_nodes {s:3d} ids: p50 {_median(lat[s]):.2f} ms, "
                f"max {max(lat[s]):.2f} ms over {REPEATS} requests")
    _detail(f"{tag} {fwd.__name__} launches {launches} over {n_req} requests; "
            f"peak device memory while serving {peak / 2**30:.2f} GiB")
    if launches != n_layers * n_req:
        raise AssertionError(f"expected {n_layers * n_req} {fwd.__name__} "
                             f"launches, got {launches}")

    _check_replays(tr, "serve", f"{tag} serving")
    # the same requests through the plain versions on the card, eagerly
    # (a replay would run the captured kernels)
    with _plain_versions(_rounded(tr)), tr.step_graphs.paused():
        d_plain = _max_diff(lambda ids: tr.predict_nodes(ids, TEST), reqs, probs)
        d_plain_emb = float(np.abs(
            tr.embed_nodes(reqs[EMBED_SIZE][0], TEST)[0] - emb).max())
    _detail(f"{tag} max |kernel - plain|: probabilities {d_plain:.3e}, "
            f"embeddings {d_plain_emb:.3e}")
    print(f"{tag} serve p50 ms by ids " + ", ".join(
        f"{s} {_median(lat[s]):.2f}" for s in sizes)
        + f"; {fwd.__name__} {launches} over {n_req} requests; vs plain "
        f"{max(d_plain, d_plain_emb):.1e}")
    if not max(d_plain, d_plain_emb) <= _tols(tr)[0]:
        raise AssertionError(f"kernel and plain serving differ by "
                             f"{max(d_plain, d_plain_emb)}")
    return reqs, {s: _median(lat[s]) for s in lat}


def _train_batch(tr, lo):
    """The TRAIN batch of the mode's nodes lo .. lo+B-1 (roots, labels,
    weights 1), as ``Trainer._run_batches`` builds it (cached branches
    gathered, khop branches sampled from a generator seeded with ``lo``)."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    b = tr.batch_size
    ent = np.asarray(tr.entity_set[TRAIN])[lo:lo + b]
    with torch.no_grad():
        batches, feats = tr._sample_branch_batches(
            TRAIN, torch.as_tensor(ent[:, None], device="cuda"),
            torch.arange(lo, lo + b, device="cuda")[:, None],
            torch.Generator(device="cuda").manual_seed(lo))
    labels = torch.as_tensor(tr.label_np[ent].astype(np.int64), device="cuda")
    return batches, feats, labels, torch.ones(b, device="cuda")


def _grad_error(grads, want, scales=None):
    """(worst max |g - want| / scale over the parameters, its name); the
    scale is max |want| of the parameter, or ``scales[name]`` where given
    (GIN's eps: ``_eps_terms``)."""
    scales = scales or {}
    return max(((grads[k] - want[k]).abs().max().item()
                / max(scales.get(k, want[k].abs().max().item()), 1e-30), k)
               for k in want)


@contextlib.contextmanager
def _eps_terms(model):
    """Within the block, a dict that a forward and backward of ``model``
    fill with the scale of each GIN conv's eps gradient: the sum of the
    |terms| of the reduction it is, sum |x * dz| over the batch, where x
    is the conv's input after dropout and z = A_gin @ x + (1 + eps) x
    the first linear's input.  eps's gradient is that sum, whose terms
    cancel, so its own size is no scale for their rounding."""
    from shadow_gnn_torch.nn.layers import GINConv
    xs, dzs, out, hooks = {}, {}, {}, []
    convs = [(n, m) for n, m in model.named_modules() if isinstance(m, GINConv)]

    def take(name, drop):
        def wrapped(feat, generator):
            x = drop(feat, generator)
            xs[name] = x.detach()
            return x
        return wrapped

    def grad_of_z(name):
        def hook(mod, args):
            args[0].register_hook(lambda g: dzs.__setitem__(name, g.detach()))
        return hook

    for name, m in convs:
        m._drop = take(name, m._drop)
        hooks.append(m.lin1.register_forward_pre_hook(grad_of_z(name)))
    try:
        yield out
        out.update({f"{n}.eps": (xs[n].float() * dzs[n].float()).abs().sum().item()
                    for n, _ in convs if n in dzs})
    finally:
        for h in hooks:
            h.remove()
        for _, m in convs:
            del m._drop


def _readout_argmax(feats_l, targets, node_mask, *_):
    """Where a max readout sends its gradients, from ResPool's inputs
    (the conv layers' [B, N, F] outputs): the layer holding the max of
    each target's row (max residue), and the node holding the max of
    each column of each layer's block (max pooling)."""
    import torch
    stack = torch.stack([f.detach() for f in feats_l], 0)          # [L, B, N, F]
    roots = stack[:, torch.arange(stack.shape[1]), targets[:, 0]]  # [L, B, F]
    pooled = stack.masked_fill(~node_mask[None, ..., None], -1e30)
    return roots.argmax(0), pooled.argmax(2)


def _first_step(tr, fwd, bwd, rng_seed):
    """One TRAIN step's loss and gradients through the kernels, through
    the plain versions, and through the forward kernels with the plain
    backwards, from the same parameters, batch, dropout generator state
    and dropedge seed.  Also counts the kinks the kernel and plain
    forwards fall on different sides of: the sign of each kinked
    activation's input (``KINKED_ACTS``) and of each attention score
    (its leaky relu), and the argmax of a max readout.  Where one
    differs, the derivative there jumps, and the all-plain gradients
    may differ by far more than the forward's last bit."""
    import torch
    from shadow_gnn_torch.nn import layers
    from shadow_gnn_torch.train.pipeline import EpochRNG
    batch = _train_batch(tr, 0)
    state = {k: v.clone() for k, v in tr.model.state_dict().items()}

    def one_step():
        kinks = []
        attention = layers.gat_attention

        def recorded(a_s, a_n, *rest):
            kinks.extend((("attention score", a_s > 0), ("attention score", a_n > 0)))
            return attention(a_s, a_n, *rest)

        hooks = [m.register_forward_pre_hook(
                     lambda m, a: kinks.append(("activation", a[0] > 0)))
                 for m in tr.model.modules()
                 if isinstance(m, layers.Act) and m.name in KINKED_ACTS]
        cfg = tr.model_cfg
        if "max" in (cfg.residue, cfg.type_pool):
            hooks.append(tr.model.res_pool.register_forward_pre_hook(
                lambda m, a: kinks.extend(zip(("max residue", "max pooling"),
                                              _readout_argmax(*a)))))
        try:
            with _Swap((layers, "gat_attention", recorded)), \
                    _eps_terms(tr.model) as terms:
                tr.model.load_state_dict(state)
                tr.model.train()
                tr.model.zero_grad(set_to_none=True)
                loss, _ = tr._forward_loss(*batch,
                                           EpochRNG.from_seed(rng_seed, tr.device))
                loss.backward()
                torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        return loss.item(), {k: p.grad.clone()
                             for k, p in tr.model.named_parameters()}, kinks, terms

    n_layers = _per_pass(tr)
    before = (fwd.launches, bwd.launches)
    loss_k, grads_k, kinks_k, _ = one_step()
    got = (fwd.launches - before[0], bwd.launches - before[1])
    if got != (n_layers, n_layers):
        raise AssertionError(f"a kernel step launched {got} (forward, backward)")
    with _plain_versions(_rounded(tr)):
        loss_p, grads_p, kinks_p, terms_p = one_step()
    with _plain_backwards():
        loss_b, grads_b, _, terms_b = one_step()
    tr.model.load_state_dict(state)
    tr.model.zero_grad(set_to_none=True)
    tr.model.eval()
    crossed = {}
    for (kind, x), (_, y) in zip(kinks_k, kinks_p):
        n, total = crossed.get(kind, (0, 0))
        crossed[kind] = (n + int((x != y).sum()), total + x.numel())
    eps = [(k, (grads_k[k] - grads_p[k]).abs().item(), grads_p[k].abs().item(), t)
           for k, t in terms_p.items()]
    return dict(loss_k=loss_k, loss_p=loss_p, loss_b=loss_b,
                err_p=_grad_error(grads_k, grads_p, terms_p),
                err_b=_grad_error(grads_k, grads_b, terms_b), n_grads=len(grads_p),
                crossed=crossed, eps=eps)


def _first_step_agreement(tr, fwd, bwd, tag):
    """Kernels against plain versions on the first TRAIN step: the loss
    within 1e-5 relative; the gradients of the backward kernels within
    1e-4 of their max of the plain backwards' under the kernels' own
    forward; and the all-plain gradients within 1e-4 of their max when
    the two forwards crossed no kink (GIN's eps within 1e-4 of the sum
    of the |terms| of its reduction instead: ``_eps_terms``).  Where
    they did, the all-plain gradients are held instead on a witness: the
    same model with a smooth activation (elu) and no max readout
    (residue none, center pooling), its weights drawn from seed 0, at
    the first of three dropout seeds whose step crosses no kink.  A model at the bf16 levels
    is held at ``TOLS_BF16`` instead."""
    if _check_step(tr, fwd, bwd, tag, 7):
        return
    with _smooth_witness(tr):
        for rng_seed in (7, 8, 9):
            if _check_step(tr, fwd, bwd, f"{tag} witness (elu, residue none, "
                           f"center pooling; dropout seed {rng_seed})", rng_seed):
                return
    raise AssertionError("every witness step crossed a kink")


def _check_step(tr, fwd, bwd, tag, rng_seed):
    """Print and hold one first step; returns whether its all-plain
    gradients were held (no kink crossed)."""
    r = _first_step(tr, fwd, bwd, rng_seed)
    rel_loss = abs(r["loss_k"] - r["loss_p"]) / abs(r["loss_p"])
    (err_p, name_p), (err_b, name_b) = r["err_p"], r["err_b"]
    n_crossed = sum(n for n, _ in r["crossed"].values())
    _detail(f"{tag} first step, kernels vs plain: loss {r['loss_k']:.7f} vs "
            f"{r['loss_p']:.7f} (rel {rel_loss:.2e}); worst gradient error "
            f"{err_p:.2e} of its max ({name_p}) over {r['n_grads']} parameters"
            f"{' (kinks crossed: not held)' if n_crossed else ''}; backward "
            f"kernels vs plain backwards (same forward, loss {r['loss_b']:.7f}): "
            f"{err_b:.2e} ({name_b}); kinks the two forwards cross: "
            + (", ".join(f"{kind} {n} of {total}"
                         for kind, (n, total) in r["crossed"].items()) or "none"))
    eps = max((diff / max(terms, 1e-30) for _, diff, _, terms in r["eps"]),
              default=None)
    for name, diff, own, terms in r["eps"]:
        _detail(f"{tag} {name}: |kernel - plain| {diff:.3e}, plain gradient "
                f"{own:.3e}, sum of |terms| {terms:.3e} (its scale): "
                f"{diff / max(terms, 1e-30):.2e}")
    print(f"{tag} step vs plain: loss {rel_loss:.1e}, grads {err_p:.1e}"
          f"{' (not held)' if n_crossed else ''}, bwd {err_b:.1e}"
          + (f", eps {eps:.1e}" if eps is not None else "")
          + f", kinks {n_crossed}")
    _, tol_loss, tol_grad = _tols(tr)
    if not (rel_loss <= tol_loss
            and abs(r["loss_b"] - r["loss_k"]) <= 1e-6 * abs(r["loss_k"])
            and err_b <= tol_grad and (n_crossed or err_p <= tol_grad)):
        raise AssertionError("kernel and plain training steps differ")
    return n_crossed == 0


@contextlib.contextmanager
def _smooth_witness(tr):
    """Within the block the trainer holds a model of its configuration
    with the elu activation (the ensemble aggregator's and GIN's inner
    one too), residue none and center pooling, its random weights drawn
    from seed 0 as the trainer's were."""
    import dataclasses
    import torch
    from shadow_gnn_torch.nn.layers import Act, GINConv, init_params
    from shadow_gnn_torch.nn.model import DeepGNN
    saved = tr.model_cfg, tr.model
    tr.model_cfg = dataclasses.replace(tr.model_cfg, act="elu", residue="none",
                                       pooling="center", ensemble_act="elu")
    tr.model = DeepGNN(tr.model_cfg)
    for m in tr.model.modules():
        if isinstance(m, GINConv):
            m.inner_act = Act("elu")
    init_params(tr.model, torch.Generator().manual_seed(0))
    tr.model.to(tr.device).eval()
    try:
        yield
    finally:
        tr.model_cfg, tr.model = saved


def phase_train(tr, reqs, fwd, bwd, tag, others=()):
    """Trainer.train() on the card through the kernels (the main path of
    training), with every step's launches of ``fwd`` and ``bwd`` checked,
    and the counts ``others`` held at 0.  Returns (launches per kernel,
    epoch-1 median step ms)."""
    import numpy as np
    import torch
    from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID

    for mode in (TRAIN, VALID):
        secs = tr.prepare_serving(mode)
        _detail(f"{tag} {MODE2STR[mode]}: PPR tables {secs['ppr_s']:.2f}s, cache "
                f"build {secs['cache_s']:.2f}s ({len(tr.entity_set[mode])} roots)")
    _first_step_agreement(tr, fwd, bwd, tag)
    n_layers = _per_pass(tr)

    steps, evals, losses, epochs = [], [], [], []
    # every step goes through _graph_*_step (a graph replay on a graphed
    # trainer)
    names = ("_graph_train_step", "_graph_eval_step")
    orig = {name: getattr(tr, name) for name in names + ("run_epoch",)}

    def counted(fn, want, log):
        def step(*args, **kw):
            f0, t0 = fwd.launches, bwd.launches
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            got = (fwd.launches - f0, bwd.launches - t0)
            if got != want:
                raise AssertionError(f"a step launched {got} (forward, "
                                     f"backward), want {want}")
            log.append(ev)
            losses.append(out[0])
            return out
        return step

    def run_epoch(epoch, mode, status="running"):
        t0 = time.perf_counter()
        stats = orig["run_epoch"](epoch, mode, status)
        epochs.append((epoch, mode, status, time.perf_counter() - t0, stats))
        return stats

    for name in names:
        setattr(tr, name, counted(orig[name], (n_layers, n_layers) if "train" in name
                                  else (n_layers, 0), steps if "train" in name else evals))
    tr.run_epoch = run_epoch
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts at 0 just before, read just after
    fwd.launches = bwd.launches = 0
    for c in others:
        c.launches = 0
    t0 = time.perf_counter()
    try:
        final = tr.train()
        torch.cuda.synchronize()
    finally:
        for name in names + ("run_epoch",):
            delattr(tr, name)
    wall = time.perf_counter() - t0
    launches = {fwd.__name__: fwd.launches, bwd.__name__: bwd.launches}
    stray = {c.__name__: c.launches for c in others if c.launches}
    peak = torch.cuda.max_memory_allocated()
    if stray:
        raise AssertionError(f"train() launched other kernels: {stray}")

    nbs = {m: -(-len(tr.entity_set[m]) // tr.batch_size)
           for m in (TRAIN, VALID, TEST)}
    nb = nbs[TRAIN]
    # VALID after every epoch, then the final TRAIN, VALID and TEST passes
    n_epochs = int(tr.params_train["end"])
    n_eval = n_epochs * nbs[VALID] + sum(nbs.values())
    if len(steps) != n_epochs * nb or len(evals) != n_eval:
        raise AssertionError(f"{len(steps)} train steps and {len(evals)} eval "
                             f"batches, want {n_epochs * nb} and {n_eval}")
    want = {fwd.__name__: n_layers * (len(steps) + len(evals)),
            bwd.__name__: n_layers * len(steps)}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError("a training or evaluation loss is not finite")
    if not all(np.isfinite(v) for st in final.values() for v in st.values()):
        raise AssertionError(f"final stats not finite: {final}")
    _check_replays(tr, "train", f"{tag} train()", TRAIN)
    _check_replays(tr, "eval", f"{tag} train()", VALID)
    moved = sum(not torch.equal(p0[k], v) for k, v in tr.model.state_dict().items())
    if moved == 0:
        raise AssertionError("training moved no parameter")

    step_ms = [a.elapsed_time(b) for a, b in steps]
    late_ms = step_ms[nb:] or step_ms       # epoch 1 on; all of a 1-epoch run
    for epoch, mode, status, secs, stats in epochs:
        if mode == TRAIN and status == "running":
            acc = {k: v for k, v in stats.items() if k != "loss"}
            _detail(f"{tag} ep {epoch} TRAIN: loss {stats['loss']:.5f}, "
                    + ", ".join(f"{k} {v:.5f}" for k, v in acc.items())
                    + f", {secs:.2f}s, {nb * tr.batch_size / secs:.0f} subgraphs/s")
    _detail(f"{tag} {len(steps)} TRAIN steps, {len(evals)} eval batches in "
            f"{wall:.2f}s; step (CUDA events) median {_median(step_ms):.3f} ms, "
            f"epoch-1 median {_median(late_ms):.3f} ms, max "
            f"{max(step_ms):.3f} ms; peak device memory {peak / 2**30:.2f} GiB")
    _detail(f"{tag} graphs: {tr.step_graphs.summary()}")
    _detail(f"{tag} launches over train(): {fwd.__name__} {launches[fwd.__name__]}"
            f" ({n_layers} per step and per eval batch), {bwd.__name__} "
            f"{launches[bwd.__name__]} ({n_layers} per step); {moved} parameters "
            f"moved" + (f"; 0 launches of {', '.join(c.__name__ for c in others)}"
                        if others else ""))
    print(f"{tag} train() {len(steps)}+{len(evals)} batches {wall:.2f}s, step "
          f"{_median(step_ms):.3f} ms (ep 1 {_median(late_ms):.3f}); "
          f"{fwd.__name__} {launches[fwd.__name__]}, {bwd.__name__} "
          f"{launches[bwd.__name__]}" + (f", {len(others)} others 0" if others else ""))

    # serving still answers, through the kernel, after training
    before = fwd.launches
    p = tr.predict_nodes(reqs[64][0], TEST)
    _check_probs(p, 64, tr.num_classes)
    if fwd.launches != before + n_layers:
        raise AssertionError(f"predict_nodes after training did not launch "
                             f"{fwd.__name__} {n_layers} times")
    return launches, _median(late_ms)


def _check_replays(tr, kind, what, mode=None):
    """On a graphed trainer whose ``mode`` (TEST by default) is cached,
    every step key of ``kind`` ("train", "eval", "serve") of that mode
    that ran must have replayed its graph: else the cached path ran
    eagerly."""
    from shadow_gnn_torch import TEST
    mode = TEST if mode is None else mode
    sg = tr.step_graphs
    if not (sg.enabled and tr._cached(mode)):
        return
    keys = [k for k in sg.warmups if k[0] == kind and k[1] == mode]
    if not keys or not all(sg.replays[k] > 0 for k in keys):
        raise AssertionError(f"{what}: the graphed trainer replayed no {kind} graph "
                             f"of a cached mode ({ {k: sg.replays[k] for k in keys} })")


def phase_uncached(tr, reqs, sizes, fwd, per_request, tag):
    """The same requests without the cache: sample + induce on the card
    per request, dense adjacency blocks; ``fwd`` must launch
    ``per_request`` times a request (SAGE aggregates the dense block with
    torch.bmm, GAT still through its kernel)."""
    import numpy as np
    from shadow_gnn_torch import TEST
    probs = {s: tr.predict_nodes(reqs[s][0], TEST) for s in sizes}
    emb = tr.embed_nodes(reqs[EMBED_SIZE][0], TEST)[0]
    tr.disable_cache(TEST)
    big = max(sizes)
    lat = []
    for ids in reqs[big][:WARMUP]:
        before = fwd.launches
        t0 = time.perf_counter()
        tr.predict_nodes(ids, TEST)
        lat.append((time.perf_counter() - t0) * 1e3)
        if fwd.launches != before + per_request:
            raise AssertionError(f"an uncached request launched {fwd.__name__} "
                                 f"{fwd.launches - before} times, want {per_request}")
    d = _max_diff(lambda ids: tr.predict_nodes(ids, TEST), reqs, probs)
    d_emb = float(np.abs(tr.embed_nodes(reqs[EMBED_SIZE][0], TEST)[0]
                         - emb).max())
    print(f"{tag} uncached predict_nodes {big} ids: p50 {_median(lat):.2f} ms over "
          f"{len(lat)} requests ({per_request} {fwd.__name__} launches each); max "
          f"|cached - uncached|: probabilities {d:.3e}, embeddings {d_emb:.3e}")
    if not max(d, d_emb) <= _tols(tr)[0]:
        raise AssertionError(f"cached and uncached serving differ by "
                             f"{max(d, d_emb)}")


def _bound(byts, ops):
    bytes_ms = byts / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _library_bmm(adj, x, bf16):
    """The library yardstick: torch.bmm of the normalised block and x.  At
    the bf16 mode (bf16 operands, f32 output) the kernels read f32, so the
    yardstick casts the f32 operands in the timed call; the product of
    operands cast beforehand is timed beside it.  Returns the two calls
    (cast + product, product alone); at f32 the product twice."""
    import torch
    if not bf16:
        return (lambda: torch.bmm(adj, x),) * 2
    adj16, x16 = adj.bfloat16(), x.bfloat16()
    return (lambda: torch.bmm(adj.bfloat16(), x.bfloat16(), out_dtype=torch.float32),
            lambda: torch.bmm(adj16, x16, out_dtype=torch.float32))


def _cast_note(bf16, call_ms):
    """The library call alone, beside the cast-inclusive time at bf16."""
    return f" with the cast (call alone {call_ms:.4f} ms)" if bf16 else ""


def _library_ms(adj, x, bf16):
    """(cast + call, call alone) ms of :func:`_library_bmm`."""
    cast_call, call = _library_bmm(adj, x, bf16)
    call_ms = _time_ms(call)
    return (_time_ms(cast_call) if bf16 else call_ms), call_ms


def phase_time(bits_all, bf16=False):
    """Both directions of packed_spmm on the cached TEST bits at every
    serving batch, rw, dropedge 0 (``bf16``: their bf16 mode, B1c)."""
    import torch
    from shadow_gnn_torch.ops.normalize import adj_norm_rw
    from shadow_gnn_torch.ops.packed import (packed_spmm, packed_spmm_plain,
                                             packed_spmm_t)
    from shadow_gnn_torch.sampling.cache import unpack_bits
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b in (8, 64, 256):
        bits = bits_all[:b].contiguous()
        _, n, nbytes = bits.shape
        adj_n = adj_norm_rw(unpack_bits(bits, n))
        nnz = int((adj_n > 0).sum())
        for f in (500, 256):
            x = torch.randn(b, n, f, device="cuda", generator=gen)
            for name, fn, lib, t in (("packed_spmm", packed_spmm, adj_n, False),
                                     ("packed_spmm_t", packed_spmm_t,
                                      adj_n.transpose(1, 2), True)):
                ms = _time_ms(lambda: fn(bits, x, "rw", bf16=bf16))
                plain_ms = _time_ms(lambda: packed_spmm_plain(bits, x, "rw",
                                                              transpose=t, bf16=bf16))
                library_ms, call_ms = _library_ms(lib, x, bf16)
                byts = b * (n * nbytes + 2 * n * f * 4)
                # forward: gather-adds + the 1/deg scale; transposed: a
                # multiply-add per entry
                ops = 2 * nnz * f if t else nnz * f + b * n * f
                bound_ms, bound_by = _bound(byts, ops)
                name += "_bf16" if bf16 else ""
                _detail(f"[time] {name:18s} rw B={b} N={n} F={f} nnz={nnz}: kernel "
                        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm "
                        f"{library_ms:.4f} ms{_cast_note(bf16, call_ms)}, bound "
                        f"{bound_ms:.4f} ms ({bound_by}: {byts / 1e6:.1f} MB, "
                        f"{ops / 1e9:.3f} GFLOP)")


def phase_time_train(bits, launches, max_abs_err, bf16=False, norm="rw"):
    """Both kernels at the training batch (B=64) on the cached TRAIN
    bits, dropedge 0.05, in the ``norm`` of the model that trained on
    them (rw: SAGE, sym: GCN, gin: GIN; ``bf16``: their bf16 mode, B1c);
    the JSON rows come from F=500, named ``packed_spmm[_t][_<norm>]``
    (no suffix for rw)."""
    import torch
    from shadow_gnn_torch.ops.packed import (_DENSE_NORM, packed_spmm,
                                             packed_spmm_plain, packed_spmm_t)
    from shadow_gnn_torch.sampling.cache import unpack_bits
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, n, nbytes = bits.shape
    # the dropedge seed as a device tensor, made once: the int form would
    # add the wrapper's fill kernel to every timed call
    seed = torch.full((), 12345, dtype=torch.int64, device="cuda")
    adj_n = _DENSE_NORM[norm](unpack_bits(bits, n), seed, DROPEDGE)
    adj_t = adj_n.transpose(1, 2)
    nnz = int((adj_n > 0).sum())
    rows = []
    for f in (500, 256):
        x = torch.randn(b, n, f, device="cuda", generator=gen)
        for name, fn, lib, t in (("packed_spmm", packed_spmm, adj_n, False),
                                 ("packed_spmm_t", packed_spmm_t, adj_t, True)):
            ms = _time_ms(lambda: fn(bits, x, norm, DROPEDGE, seed, bf16=bf16))
            plain_ms = _time_ms(lambda: packed_spmm_plain(bits, x, norm, DROPEDGE,
                                                          seed, t, bf16))
            library_ms, call_ms = _library_ms(lib, x, bf16)
            name += ("" if norm == "rw" else f"_{norm}") + ("_bf16" if bf16 else "")
            byts = b * (n * nbytes + 2 * n * f * 4)
            # forward: gather-adds (sym: a multiply-add, the column scale)
            # + the row scale; transposed: a multiply-add per surviving entry
            ops = (2 * nnz * f if t
                   else (2 if norm == "sym" else 1) * nnz * f + b * n * f)
            bound_ms, bound_by = _bound(byts, ops)
            _detail(f"[time] {name:17s} {norm} p={DROPEDGE} B={b} N={n} F={f} "
                    f"nnz={nnz}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"torch.bmm {library_ms:.4f} ms{_cast_note(bf16, call_ms)}, bound "
                    f"{bound_ms:.4f} ms ({bound_by}: {byts / 1e6:.1f} MB, "
                    f"{ops / 1e9:.3f} GFLOP)")
            if f == 500:
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "shadow_gnn_torch/csrc/packed_spmm.cu",
                    "replaces": "shadow_gnn_tpu/ops/pallas_packed.py:"
                                + {(0, 0): "83", (1, 0): "153", (0, 1): "90",
                                   (1, 1): "155"}[t, bf16],
                    "launches": launches[name],
                    "max_abs_err": max_abs_err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms,
                    "library_call_ms": call_ms})
    return rows


def _profile(label, fn, n, wall_ms, top=True):
    """torch.profiler over n calls of fn: device-busy time per call, its
    share of the unprofiled ``wall_ms``, and (``top``) the top kernels
    and host operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    kern, host = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.is_user_annotation:
            continue        # a range over kernels (Optimizer.step), not a kernel
        bucket = kern if e.device_type == DeviceType.CUDA else host
        cnt, us = bucket.get(e.name, (0, 0.0))
        own = (e.time_range.elapsed_us() if bucket is kern
               else e.self_cpu_time_total)
        bucket[e.name] = (cnt + 1, us + own)
    busy_ms = sum(us for _, us in kern.values()) / 1e3 / n
    if busy_ms == 0.0:
        print(f"[profile] {label}: the profiler saw no device time "
              "(device-busy share not measured)")
        return
    print(f"[profile] {label}: device busy {busy_ms:.3f} ms per call, "
          f"{sum(c for c, _ in kern.values()) / n:.0f} device events per call; "
          f"unprofiled {wall_ms:.2f} ms -> device busy share "
          f"{busy_ms / wall_ms:.3f}")
    if not top:
        return
    for name, (cnt, us) in sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   device {us / 1e3 / n:8.4f} ms/call "
              f"{cnt / n:5.1f}x  {name[:90]}")
    for name, (cnt, us) in sorted(host.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   host   {us / 1e3 / n:8.4f} ms/call "
              f"{cnt / n:5.1f}x  {name[:90]}")


def _gat_train_operands(tr):
    """The attention's operands at the training shape: the cached TRAIN
    blocks of the first batch (dropedge 0.1, a fixed seed) and random
    score terms, values and output gradient.  Returns ((att_self,
    att_neigh, values, adj_norm, adj_struct), g)."""
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.ops.normalize import adj_drop
    from shadow_gnn_torch.sampling.cache import unpack_bits
    gen = torch.Generator(device="cuda").manual_seed(4)
    bits = tr.caches[TRAIN][0].adj_bits[:tr.batch_size].contiguous()
    b, n, _ = bits.shape
    h = tr.model_cfg.mulhead
    dh = tr.model_cfg.dim // h
    adj = unpack_bits(bits, n)
    adj_n = adj_drop(adj, 12345, GAT_DROPEDGE)
    a_s = torch.randn(b, h, n, device="cuda", generator=gen)
    a_n = torch.randn(b, h, n, device="cuda", generator=gen)
    v = torch.randn(b, n, h, dh, device="cuda", generator=gen)
    g = torch.randn(b, n, h, dh, device="cuda", generator=gen)
    return (a_s, a_n, v, adj_n, adj), g


def _print_clocks(name, lib, grid, phases):
    """The stamps of the instrumented kernels' last launch (``grid`` CTAs):
    the median of each phase over the CTAs, the median and longest CTA,
    the launch's span and the SMs it ran on."""
    import ctypes
    import numpy as np
    import torch
    fn = lib.gat_attention_clocks
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]
    buf = torch.zeros(grid * 8, dtype=torch.int64)
    if fn(buf.data_ptr(), grid) != 0:
        raise RuntimeError("could not read the GAT kernels' phase clocks")
    x = buf.numpy().view(np.uint64).reshape(grid, 8)
    t = (x >> np.uint64(8)).astype(np.float64) / 1e3            # us
    k = len(phases)
    per = [float(np.median(t[:, i + 1] - t[:, i])) for i in range(k)]
    cta = t[:, k] - t[:, 0]
    _detail(f"[phases] {name}: span {t[:, k].max() - t[:, 0].min():.2f} us over "
            f"{len(set((x[:, 0] & np.uint64(0xff)).tolist()))} SMs, CTA median "
            f"{np.median(cta):.2f} us, longest {cta.max():.2f}; phase medians (us): "
            + ", ".join(f"{p} {v:.2f}" for p, v in zip(phases, per)))


def phase_clocks_gat(tr):
    """Where B2 and B3 spend their time at the training shape (f32): one
    launch of each through the instrumented copy of the kernels (built
    with -DGAT_PHASE_CLOCKS; thread 0 of each CTA stamps %globaltimer at
    each phase boundary), then both kernels timed with clusters of 1, 2
    and 4 CTAs of a subgraph (the launch takes 2)."""
    import torch
    from shadow_gnn_torch.ops import build, gat
    args, g = _gat_train_operands(tr)
    b, h, n = args[0].shape
    d = gat.launch_dims(b, n, h, args[2].shape[-1])
    lib = build.load("gat_attention_clocks")
    with _Swap((gat, "LIBRARY", "gat_attention_clocks")), torch.no_grad():
        out = gat._forward(*args)
        torch.cuda.synchronize()
        _print_clocks("gat_attention", lib, d.fwd_grid,
                      ("bitmap", "slots", "e and D", "gather"))
        gat.gat_attention_bwd(*args, out, g)
        torch.cuda.synchronize()
        _print_clocks("gat_attention_bwd", lib, d.bwd_grid,
                      ("bitmap", "slots", "e and D", "r", "columns", "da_s"))
    dims = gat.launch_dims
    for cl in (1, 2, 4):
        def clustered(*shape, cl=cl):
            return dims(*shape)._replace(fwd_cluster=cl, bwd_cluster=cl)
        with _Swap((gat, "launch_dims", clustered)), torch.no_grad():
            fwd_ms = _time_ms(lambda: gat._forward(*args))
            bwd_ms = _time_ms(lambda: gat.gat_attention_bwd(*args, out, g))
        _detail(f"[phases] clusters of {cl}: gat_attention {fwd_ms:.4f} ms, "
                f"gat_attention_bwd {bwd_ms:.4f} ms")


def phase_time_gat(tr, launches, max_abs_err, bf16=False):
    """B2 and B3 at the training shape (B=128, N=152, H=4, dh=128) on the
    cached TRAIN blocks, dropedge 0.1, beside their bound, their plain
    versions and scaled_dot_product_attention (forward; its backward as
    forward + backward less forward).  ``bf16``: B2b and B3b at the
    level the bf16-precision model runs (``bf16`` + ``bf16_scores``, f32
    values), SDPA on bf16 operands, timed with the cast of its f32
    operands (``library_ms``) and alone (``library_call_ms``).  Returns
    the two JSON rows."""
    import torch
    from shadow_gnn_torch.ops.gat import (gat_attention, gat_attention_bwd,
                                          gat_attention_bwd_plain,
                                          gat_attention_plain)
    args, g = _gat_train_operands(tr)
    a_s, a_n, v, adj_n, adj = args
    b, h, n = a_s.shape
    dh = v.shape[-1]
    nnz_s, nnz_k = int((adj > 0).sum()), int((adj_n > 0).sum())
    lv = dict(bf16=bf16, bf16_scores=bf16)
    # contiguous, as the forward kernel's output that the model's backward
    # receives (the plain version returns a permuted view, whose copy would
    # be timed with the backward)
    out = gat_attention_plain(*args, **lv).contiguous()

    # the library yardstick: q = [a_s, 1, 0...], k = [1, a_n, 0...], so
    # q.k = a_s[i] + a_n[j], softmax over the kept edges
    q = torch.zeros(b, h, n, dh, device="cuda")
    k = torch.zeros_like(q)
    q[..., 0], q[..., 1] = a_s, 1.0
    k[..., 0], k[..., 1] = 1.0, a_n
    vh = v.permute(0, 2, 1, 3).contiguous()
    gh = g.permute(0, 2, 1, 3).contiguous()
    mask = (adj_n > 0)[:, None]
    qkv = [t.requires_grad_() for t in (q, k, vh)]
    # at bf16: the kernels read f32, so the yardstick casts its f32 operands
    # in the timed call; operands cast beforehand give the call alone
    qkv16 = [t.detach().bfloat16().requires_grad_() for t in qkv] if bf16 else qkv
    g16 = gh.bfloat16() if bf16 else gh
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def operands(cast):
        if cast and bf16:
            return [t.bfloat16() for t in qkv], qkv, gh.bfloat16()
        return qkv16, qkv16, g16

    def sdpa_fwd(cast):
        with torch.no_grad():
            return sdpa(*operands(cast)[0], attn_mask=mask, scale=1.0)

    def sdpa_fwd_bwd(cast):
        ops, leaves, gg = operands(cast)
        return torch.autograd.grad(sdpa(*ops, attn_mask=mask, scale=1.0), leaves, gg)

    with torch.no_grad():
        fwd_ms = _time_ms(lambda: gat_attention(*args, **lv))
        fwd_plain = _time_ms(lambda: gat_attention_plain(*args, **lv))
        bwd_ms = _time_ms(lambda: gat_attention_bwd(*args, out, g, **lv))
        bwd_plain = _time_ms(lambda: gat_attention_bwd_plain(*args, out, g, **lv))
    lib = {}
    for cast in (True, False) if bf16 else (False,):
        f_ms = _time_ms(lambda: sdpa_fwd(cast))
        fb_ms = _time_ms(lambda: sdpa_fwd_bwd(cast))
        lib[cast] = (f_ms, fb_ms - f_ms, fb_ms)
    lib.setdefault(True, lib[False])
    att, blk, adjb = 4 * b * h * n, 4 * b * n * h * dh, 4 * b * n * n
    # scores on every structural entry (add, subtract, exp, scale, sum),
    # dh multiply-adds per kept entry; backward: g.v and P g per kept
    # entry, g.out per row
    cases = (
        ("gat_attention", fwd_ms, fwd_plain, 0, "_fwd_kernel",
         2 * att + 2 * blk + 2 * adjb,
         h * (5 * nnz_s + 2 * dh * nnz_k) + b * n * h * dh),
        ("gat_attention_bwd", bwd_ms, bwd_plain, 1, "_bwd_kernel",
         4 * att + 4 * blk + 2 * adjb,
         h * (5 * nnz_s + (4 * dh + 4) * nnz_k) + 2 * b * n * h * dh))
    line = ({"_fwd_kernel": 93, "_bwd_kernel": 112} if bf16
            else {"_fwd_kernel": 85, "_bwd_kernel": 101})
    rows = []
    for name, ms, plain_ms, which, tpu_fn, byts, ops in cases:
        name += "_bf16" if bf16 else ""
        bound_ms, bound_by = _bound(byts, ops)
        lib_ms, call_ms = lib[True][which], lib[False][which]
        note = (f" (fwd+bwd {lib[True][2]:.4f} less fwd)" if which else "")
        _detail(f"[time] {name:22s} B={b} N={n} H={h} dh={dh} p={GAT_DROPEDGE} "
                f"nnz={nnz_s} kept={nnz_k}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms"
                f"{note}{_cast_note(bf16, call_ms)}, bound {bound_ms:.4f} ms "
                f"({bound_by}: {byts / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
        rows.append({
            "name": name, "route": "cuda",
            "source": "shadow_gnn_torch/csrc/gat_attention.cu",
            "replaces": f"shadow_gnn_tpu/ops/pallas_gat.py:{line[tpu_fn]}",
            "launches": launches[name], "max_abs_err": max_abs_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "library_call_ms": call_ms})
    return rows


def phase_profile(tr, reqs, p50, sizes, tag):
    """Device-busy time of cached requests, from a torch.profiler trace."""
    from shadow_gnn_torch import TEST
    for s in sizes:
        _profile(f"{tag} {s:3d} ids", lambda i: tr.predict_nodes(reqs[s][i], TEST),
                 10, p50[s])


def phase_profile_train(tr, step_ms, tag):
    """Device-busy share of a TRAIN step as ``train()`` runs it (a graph
    replay on a graphed trainer): a profile of 5 steps against the main
    path's epoch-1 median step time (``step_ms``)."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.train.pipeline import EpochRNG
    rng = EpochRNG.from_seed(11, tr.device)
    b = tr.batch_size
    nb = len(tr.entity_set[TRAIN]) // b
    ent = np.asarray(tr.entity_set[TRAIN])
    roots = torch.as_tensor(ent[:, None], device="cuda")
    rows = torch.arange(ent.size, device="cuda")[:, None]
    labels = torch.as_tensor(tr.label_np[ent].astype(np.int64), device="cuda")
    w = torch.ones(b, device="cuda")
    tr.model.train()
    sg = tr.step_graphs
    with sg.dropout(rng.dropout) as gen, sg.sampling(rng.sample) as sampler:
        def step(i):
            sl = slice(b * (i % nb), b * (i % nb + 1))
            tr._graph_train_step(TRAIN, roots[sl], rows[sl], labels[sl], w, rng,
                                 gen, sampler)
        step(0)                                         # warm
        _profile(f"{tag} TRAIN step (B={b})", lambda i: step(i + 1), 5, step_ms)
    tr.model.eval()


class _NormLaunches:
    """One norm's launch count of a packed kernel (both modes), read and
    set as ``.launches``, named ``<wrapper>_<norm>``."""

    def __init__(self, fn, norm):
        self.fn, self.norm, self.__name__ = fn, norm, f"{fn.__name__}_{norm}"

    @property
    def launches(self):
        return self.fn.launches_by_norm[self.norm]

    @launches.setter
    def launches(self, value):
        self.fn.launches_by_norm[self.norm] = value


def _matrix_counts(fwd, bwd):
    """Every kernel count but ``fwd``'s and ``bwd``'s: the packed kernels
    per norm (both directions) and B2, B3."""
    from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
    from shadow_gnn_torch.ops.packed import NORMS, packed_spmm, packed_spmm_t
    counts = [_NormLaunches(fn, n) for fn in (packed_spmm, packed_spmm_t)
              for n in NORMS]
    counts += [gat_attention, gat_attention_bwd]
    return [c for c in counts if c.__name__ not in (fwd.__name__, bwd.__name__)]


def _check_final(tr, tag):
    """The final stats of ``train()``: finite losses, accuracies in [0, 1]."""
    import numpy as np
    from shadow_gnn_torch import MODE2STR
    final = tr.logger.final_stats
    for mode, st in final.items():
        if not (np.isfinite(st["loss"]) and 0.0 <= st["accuracy"] <= 1.0):
            raise AssertionError(f"{tag} bad final stats {final}")
    _detail(f"{tag} final stats: " + "; ".join(
        f"{MODE2STR[m]}: loss {st['loss']:.4f}, accuracy {st['accuracy']:.4f}"
        for m, st in final.items()))
    print(f"{tag} final acc " + "/".join(f"{st['accuracy']:.4f}"
                                          for st in final.values()))


MATRIX_BUDGET_S = 200


def phase_matrix(g, max_abs_err, profile=False):
    """[matrix]: GCN-3, GIN-3 and GATScatter-3 serve, train and serve
    uncached through their kernels on the flickr-scale graph ``g``, with
    every other kernel count held at 0 over ``train()``; SIGN trains
    through the ``full`` sampler with no kernel; B1a/B1b timed in ``sym``
    and ``gin``.  Returns the kernel rows of those two norms."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_t
    t_phase = time.perf_counter()
    rows = []
    for aggr, arch in (("gcn", {"aggr": "gcn"}), ("gin", {"aggr": "gin"}),
                       ("gatscat", {"aggr": "gatscat", "heads": 4})):
        tag = f"[matrix {aggr}]"
        t0 = time.perf_counter()
        tr = _flagship_trainer(g, arch=arch, tag=tag)
        cfg = tr.model_cfg
        if (cfg.aggr != aggr or cfg.reads_packed_bits == (aggr == "gatscat")
                or tr.branches[0]["cfg"][TRAIN].add_self_edge == (aggr == "gin")):
            raise AssertionError(f"{tag} trainer: aggr {cfg.aggr}, packed "
                                 f"{cfg.reads_packed_bits}, self edges "
                                 f"{tr.branches[0]['cfg'][TRAIN].add_self_edge}")
        if aggr == "gatscat":
            fwd, bwd, uncached = gat_attention, gat_attention_bwd, _per_pass(tr)
        else:
            norm = {"gcn": "sym", "gin": "gin"}[aggr]
            fwd, bwd = _NormLaunches(packed_spmm, norm), _NormLaunches(packed_spmm_t,
                                                                       norm)
            # an uncached batch aggregates its dense block with torch.bmm
            uncached = 0
        reqs, _ = phase_serve(tr, SERVE_SIZES, fwd, tag)
        launches, step_ms = phase_train(tr, reqs, fwd, bwd, tag,
                                        others=_matrix_counts(fwd, bwd))
        _check_final(tr, tag)
        if profile:
            phase_profile_train(tr, step_ms, f"matrix {aggr}")
        if aggr != "gatscat":
            rows += phase_time_train(
                tr.caches[TRAIN][0].adj_bits[:tr.batch_size].contiguous(), launches,
                max_abs_err, norm=norm)
        phase_uncached(tr, reqs, SERVE_SIZES, fwd, uncached, tag)
        print(f"{tag} part {time.perf_counter() - t0:.1f}s")
        del tr, reqs
        torch.cuda.empty_cache()

    # SIGN: the propagation runs in the preprocessing, on the card; the
    # full train sampler gives nodeIID batches; no kernel on its path
    tag = "[matrix sign]"
    t0 = time.perf_counter()
    tr = _flagship_trainer(
        g, arch={"aggr": "sign", "feature_smoothen": "sym-3-concat",
                 "feature_augment": "none"},
        sampler=[{"method": "full", "phase": "train"}], tag=tag)
    log = tr.preproc_log
    print(f"{tag} preprocessing: feature smoothening {log['feature_smoothen_s']:.2f}s"
          f", {log['feature_smoothen_steps']} steps; {tr.dim_feat_smooth} input "
          f"columns, feature table {tr.feat_tab.numel() * 4 / 1e6:.0f} MB")
    if (tr.dim_feat_smooth != 4 * tr.dim_feat_raw
            or tr.branches[0]["cfg"][TRAIN].method != "nodeIID"):
        raise AssertionError(f"{tag} {tr.dim_feat_smooth} columns, sampler "
                             f"{tr.branches[0]['cfg'][TRAIN].method}")
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    with _no_kernel_launches("train() and 64-id requests", tag):
        t1 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        ids = np.asarray(tr.entity_set[TRAIN])[:EMBED_SIZE]
        _check_probs(tr.predict_nodes(ids, TRAIN), EMBED_SIZE, tr.num_classes)
    moved = sum(not torch.equal(p0[k], v) for k, v in tr.model.state_dict().items())
    if moved != len(p0):
        raise AssertionError(f"{tag} training moved {moved} of {len(p0)} parameters")
    _check_final(tr, tag)
    nb = -(-len(tr.entity_set[TRAIN]) // tr.batch_size)
    print(f"{tag} train() {secs:.2f}s ({int(tr.params_train['end'])} epochs of "
          f"{nb} nodeIID steps, n_pad {tr.branches[0]['cfg'][TRAIN].n_pad}, and "
          f"the evaluation passes); part {time.perf_counter() - t0:.1f}s")
    del tr
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[matrix] phase {wall:.1f}s (budget {MATRIX_BUDGET_S} s)")
    if wall > MATRIX_BUDGET_S:
        raise AssertionError(f"[matrix] took {wall:.1f}s, over its "
                             f"{MATRIX_BUDGET_S} s budget")
    return rows


REST_BUDGET_S = 240             # the phase aims at 150 s
REST_PPR_BLOCK = 512            # targets of a device PPR block
REST_SMOOTH_TARGETS = 512       # targets a mode of the subgraph smoothening check
INGEST_NODES = 20_000           # the synthetic OGB-raw archive
INGEST_SPLITS = (1024, 256, 256)


def _rest_counters(norm=None, bf16=False):
    """(fwd, bwd, others) of a [rest] model: the packed kernels in
    ``norm`` (per norm, both modes), or with no norm the attention
    kernels' bf16 levels; ``others`` every other count, which must stay 0
    over ``train()``: the packed kernels' other norms and the mode not
    taken, and the attention's levels not taken."""
    from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
    from shadow_gnn_torch.ops.packed import NORMS, packed_spmm, packed_spmm_t
    b1c, b1c_t, b2b, b3b = _bf16_counts()
    per_norm = [(fn, n) for fn in (packed_spmm, packed_spmm_t) for n in NORMS]
    if norm is None:
        return b2b, b3b, ([_NormLaunches(fn, n) for fn, n in per_norm]
                          + [gat_attention, gat_attention_bwd])
    others = [_NormLaunches(fn, n) for fn, n in per_norm if n != norm]
    others += [packed_spmm, packed_spmm_t] if bf16 else [b1c, b1c_t]
    others += [gat_attention, gat_attention_bwd, b2b, b3b]
    return (_NormLaunches(packed_spmm, norm), _NormLaunches(packed_spmm_t, norm),
            others)


def _rest_reqs(tr):
    """The request ``phase_train`` serves after training: 64 TEST ids."""
    import numpy as np
    from shadow_gnn_torch import TEST
    return {EMBED_SIZE: [np.asarray(tr.entity_set[TEST])[:EMBED_SIZE]]}


def _loss_grads(tr, batch, rng_seed):
    """(loss, gradients, the sign of each kinked activation's input) of
    one TRAIN step of the trainer's model on ``batch``, with the dropout
    generator seeded ``rng_seed``."""
    from shadow_gnn_torch.nn import layers
    from shadow_gnn_torch.train.pipeline import EpochRNG
    signs = []
    hooks = [m.register_forward_pre_hook(lambda m, a: signs.append(a[0] > 0))
             for m in tr.model.modules()
             if isinstance(m, layers.Act) and m.name in KINKED_ACTS]
    tr.model.train()
    tr.model.zero_grad(set_to_none=True)
    try:
        loss, _ = tr._forward_loss(*batch, EpochRNG.from_seed(rng_seed, tr.device))
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters()}
    tr.model.zero_grad(set_to_none=True)
    tr.model.eval()
    return loss.item(), grads, signs


@contextlib.contextmanager
def _f32_model(tr):
    """Within the block the trainer holds its model at f32 precision,
    with the same weights."""
    import dataclasses
    from shadow_gnn_torch.nn.model import DeepGNN
    saved = tr.model_cfg, tr.model
    tr.model_cfg = dataclasses.replace(tr.model_cfg, matmul_precision="float32")
    tr.model = DeepGNN(tr.model_cfg).to(tr.device)
    tr.model.load_state_dict(saved[1].state_dict())
    try:
        yield
    finally:
        tr.model_cfg, tr.model = saved


def _rest_train(tr, tag, norm=None, bf16=False):
    """``phase_train`` of a [rest] model, its final stats checked; returns
    its launches over ``train()``."""
    fwd, bwd, others = _rest_counters(norm, bf16)
    launches, _ = phase_train(tr, _rest_reqs(tr), fwd, bwd, tag, others=others)
    _check_final(tr, tag)
    return launches


def _topk_overlap(a, b):
    """Mean over rows of |row of a & row of b| / k for [T, k] node tables
    (-1 padding never matches)."""
    import torch
    sb = torch.sort(b, dim=1).values
    at = torch.searchsorted(sb, a).clamp(max=b.shape[1] - 1)
    hit = (torch.gather(sb, 1, at) == a) & (a >= 0)
    return hit.sum(1).float().div(a.shape[1]).mean().item()


def _rest_device_ppr(g, host_tabs, host_s, tag="[rest device ppr]"):
    """f and g: the flagship trainer with ``use_device_ppr=True``; its
    tables of the three modes by the power iteration on the card (timed
    beside the host push), one block against the CPU run of the same
    function and against a second card run, the mean top-k overlap with
    the host push's tables, then one epoch from the device tables with
    the first epoch's subgraph profile."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.sampling import ppr as ppr_mod
    tr = _flagship_trainer(g, epochs=1, tag=tag, use_device_ppr=True)
    if not tr.use_device_ppr:
        raise AssertionError(f"{tag} the trainer plans the host push")
    modes = (TRAIN, VALID, TEST)
    n_t = sum(len(tr.entity_set[m]) for m in modes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m in modes:
        tr._ensure_tables(m)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    _, batch = ppr_mod.plan_device_ppr(tr.num_nodes, int(tr._host_adj[TRAIN][1].size),
                                       tr._memory_bytes)
    blocks = sum(-(-len(tr.entity_set[m]) // batch) for m in modes)
    overlap = {m: _topk_overlap(tr.tables[m][0].neighs, host_tabs[m]) for m in modes}
    print(f"{tag} {n_t} targets in {blocks} blocks of {batch}: device {dev_s:.2f}s, "
          f"{n_t / dev_s:.0f} targets/s; host push {host_s:.2f}s, "
          f"{n_t / host_s:.0f} targets/s; mean top-k overlap with the push's "
          "tables " + ", ".join(f"{k} {v:.4f}" for k, v in zip(
              ("TRAIN", "VALID", "TEST"), overlap.values())) + " (no bound: "
          "another estimator)")
    # one block: card against CPU, and a second card run
    ip, ix = tr._host_adj[TRAIN]
    blk = np.asarray(tr.entity_set[TRAIN])[:REST_PPR_BLOCK]
    k = tr.branches[0]["cfg"][TRAIN].k
    alpha = tr.branches[0]["cfg"][TRAIN].alpha
    card = ppr_mod.ppr_power_device(ip, ix, blk, k, alpha, batch=REST_PPR_BLOCK,
                                    device="cuda")
    again = ppr_mod.ppr_power_device(ip, ix, blk, k, alpha, batch=REST_PPR_BLOCK,
                                     device="cuda")
    t0 = time.perf_counter()
    cpu = ppr_mod.ppr_power_device(ip, ix, blk, k, alpha, batch=REST_PPR_BLOCK,
                                   device="cpu")
    cpu_s = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(card[0] + card[1],
                                                    again[0] + again[1]))
    worst, n_diff = 0.0, 0
    for (cn, cs), (wn, ws) in zip(zip(*card), zip(*cpu)):
        if cn.size != wn.size:
            raise AssertionError(f"{tag} a row holds {cn.size} on the card, "
                                 f"{wn.size} on the CPU")
        worst = max(worst, float(np.max(np.abs(cs - ws) / ws)) if ws.size else 0.0)
        cut = ws[-1] * (1 + 2e-5) if wn.size == k else 0.0
        n_diff += set(cn[cs > cut].tolist()) != set(wn[ws > cut].tolist())
    print(f"{tag} block of {blk.size} TRAIN targets, card against CPU "
          f"({cpu_s:.2f}s): scores rel {worst:.2e}, rows whose neighbour sets "
          f"differ outside ties {n_diff}; two card runs equal: {same}")
    if not (worst <= 1e-5 and n_diff == 0 and same):
        raise AssertionError(f"{tag} device PPR disagrees: rel {worst}, "
                             f"{n_diff} rows, deterministic {same}")
    # g: the first epoch's subgraph profile of this run
    summaries = []
    printed = tr.profiler.print_summary

    def keep_summary():
        summaries.append(tr.profiler.summary())
        printed()

    tr.profiler.print_summary = keep_summary
    launches = _rest_train(tr, tag, "rw")
    if len(summaries) != 1 or tr.profiler.enabled:
        raise AssertionError(f"{tag} the profile ran {len(summaries)} times, "
                             f"enabled after: {tr.profiler.enabled}")
    s = summaries[0]
    hops = ", ".join(f"{v:.3f}" for v in s["hop_composition"][0])
    _detail(f"[rest profiler] first TRAIN epoch's subgraphs: avg nodes "
          f"{s['avg_nodes'][0]:.1f}, avg edges {s['avg_edges'][0]:.1f}, avg deg "
          f"{s['avg_deg'][0]:.2f}; hop composition (unreached, self, 1-5 hops) "
          f"{hops}; launches over train() {launches}, those of a profile-off "
          "run (the pass launches no kernel)")
    del tr
    torch.cuda.empty_cache()


def _rest_smooth(g, tag="[rest smooth]"):
    """e: ``smooth_signal_subgraph`` (a ppr preprocess sampler, sym-2-concat)
    over the first ``REST_SMOOTH_TARGETS`` nodes of each mode on the card,
    against the same call on the CPU."""
    import types
    import numpy as np
    from shadow_gnn_torch.train.preproc import (decode_smoothen_config,
                                                smooth_signal_subgraph)
    sets = {m: np.asarray(v)[:REST_SMOOTH_TARGETS] for m, v in g.node_set.items()}
    out, secs = {}, {}
    for where, dev in (("card", "cuda"), ("cpu", "cpu")):
        fake = types.SimpleNamespace(
            task="node", batch_size=64, num_nodes=g.num_nodes, device=dev,
            _host_adj={m: g.adj(m) for m in sets}, entity_set=sets)
        t0 = time.perf_counter()
        out[where], steps = smooth_signal_subgraph(
            fake, g.feat_full.astype(np.float32), *decode_smoothen_config("sym-2-concat"),
            {"method": "ppr", "k": 200, "epsilon": 1e-6})
        secs[where] = time.perf_counter() - t0
    rows = np.concatenate(list(sets.values()))
    err = float(np.abs(out["card"][rows] - out["cpu"][rows]).max())
    scale = float(np.abs(out["cpu"][rows]).max())
    print(f"{tag} smooth_signal_subgraph sym-2-concat, ppr k 200 over "
          f"{rows.size} targets, {out['card'].shape[1]} columns: card "
          f"{secs['card']:.2f}s, CPU {secs['cpu']:.2f}s, max |card - CPU| "
          f"{err:.3e} ({err / scale:.2e} of max), {steps} steps")
    if not (err <= 1e-5 * max(scale, 1.0) and np.isfinite(out["card"]).all()
            and (np.abs(out["card"][rows]).sum(1) > 0).all()):
        raise AssertionError(f"{tag} card and CPU smoothening differ by {err}")


def _ogb_raw_tarball(root, seed=0):
    """A synthetic OGB-raw archive of the arxiv kind made from ``seed`` in
    ``root``: raw/ gzip CSVs (edges, node count, 128 features, labels)
    and split/time/ CSVs of the first ``INGEST_SPLITS`` of a permutation.
    Returns (archive path, the graph it holds)."""
    import gzip
    import tarfile
    import numpy as np
    from shadow_gnn_torch.data import make_synthetic_dataset
    g = make_synthetic_dataset(num_nodes=INGEST_NODES, avg_deg=10.0, num_feat=128,
                               num_classes=40, seed=seed, power_law=False)
    pkg = os.path.join(root, "arxiv_pkg")
    raw_d, split_d = os.path.join(pkg, "raw"), os.path.join(pkg, "split", "time")
    os.makedirs(raw_d), os.makedirs(split_d)

    def write(path, arr, fmt):
        with gzip.open(path, "wt", compresslevel=1) as f:
            np.savetxt(f, arr, fmt=fmt, delimiter=",")

    src = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr_full))
    write(os.path.join(raw_d, "edge.csv.gz"), np.stack([src, g.indices_full], 1), "%d")
    write(os.path.join(raw_d, "num-node-list.csv.gz"), [[g.num_nodes]], "%d")
    write(os.path.join(raw_d, "node-feat.csv.gz"), g.feat_full, "%.6f")
    write(os.path.join(raw_d, "node-label.csv.gz"), g.label_full[:, None], "%d")
    perm = np.random.default_rng(seed).permutation(g.num_nodes)
    lo = 0
    for name, n in zip(("train", "valid", "test"), INGEST_SPLITS):
        write(os.path.join(split_d, f"{name}.csv.gz"), perm[lo:lo + n, None], "%d")
        lo += n
    path = os.path.join(root, "arxiv.tar.gz")
    with tarfile.open(path, "w:gz", compresslevel=1) as t:
        t.add(pkg, arcname="arxiv_pkg")
    return path, g


def _rest_ingest(tmp, tag="[rest ingest]"):
    """i: the synthetic OGB-raw archive through ``ingest_tarball``,
    ``load_data`` and a flagship trainer with a dict config, 1 epoch."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.data import load_data
    from shadow_gnn_torch.data.converter import ingest_tarball
    t0 = time.perf_counter()
    path, g = _ogb_raw_tarball(tmp)
    t1 = time.perf_counter()
    ingest_tarball(path, "arxiv", os.path.join(tmp, "data"))
    t2 = time.perf_counter()
    raw = load_data(os.path.join(tmp, "data"), "arxiv",
                    {"to_undirected": True, "transductive": True})
    if not (raw.num_nodes == g.num_nodes and raw.feat_full.shape == (g.num_nodes, 128)
            and np.array_equal(raw.label_full, g.label_full)
            and len(raw.node_set[TRAIN]) == INGEST_SPLITS[0]):
        raise AssertionError(f"{tag} the ingested dataset is not the archive's")
    print(f"{tag} OGB-raw archive of {g.num_nodes} nodes, {g.indices_full.size} "
          f"edges, 128 features ({os.path.getsize(path) / 1e6:.1f} MB) made in "
          f"{t1 - t0:.2f}s, ingested in {t2 - t1:.2f}s")
    tr = _flagship_trainer(raw, epochs=1, tag=tag, name="arxiv",
                           data_dir=os.path.join(tmp, "data"))
    _rest_train(tr, tag, "rw")
    del tr
    torch.cuda.empty_cache()


def _check_trace(trace_dir, tag):
    """The one Chrome trace in ``trace_dir`` holds device kernels, the
    packed kernels among them; returns (events, packed kernel events)."""
    files = os.listdir(trace_dir)
    if len(files) != 1 or not files[0].endswith(".json"):
        raise AssertionError(f"{tag} trace dir holds {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    packed = [e for e in kernels if "packed_spmm_kernel" in e.get("name", "")]
    print(f"{tag} trace of TRAIN epoch 1: {len(events)} events, {len(kernels)} "
          f"device kernels, {len(packed)} of them the packed kernels "
          f"({os.path.getsize(os.path.join(trace_dir, files[0])) / 1e6:.1f} MB)")
    if not packed:
        raise AssertionError(f"{tag} the trace names no packed kernel")
    return len(events), len(packed)


def phase_rest(g):
    """[rest]: the remaining single-card capabilities on the flickr-scale
    graph ``g`` with ``[matrix]``'s cuts, 1 epoch each but the TF32 one:
    a. GCN-3 and GIN-3 at bf16 precision (B1c sym, gin); b. GATScatter-3
    at bf16 precision (B2b/B3b, att_self = 0); c. the flagship at TF32
    (B1c rw), its first step against its plain versions and beside the
    f32 model's, 2 epochs, h. epoch 1 traced; d. the flagship with
    pairnorm; e. ``smooth_signal_subgraph`` card against CPU; f. device
    PPR and g. the subgraph profile (``_rest_device_ppr``); i. ingestion
    (``_rest_ingest``).  The host push's tables are cached in a temp dir
    for the phase's trainers."""
    import shutil
    import tempfile
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    try:
        modes = (TRAIN, VALID, TEST)
        host_tabs = host_s = None
        for aggr, norm in (("gcn", "sym"), ("gin", "gin"), ("gatscat", None)):
            tag = f"[rest {aggr} bf16]"
            t0 = time.perf_counter()
            arch = {"aggr": aggr, **({"heads": 4} if norm is None else {})}
            tr = _flagship_trainer(g, epochs=1, arch=arch, tag=tag, data_dir=tmp,
                                   matmul_precision="bfloat16")
            if host_tabs is None:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for m in modes:
                    tr._ensure_tables(m)
                host_s = time.perf_counter() - t1
                host_tabs = {m: tr.tables[m][0].neighs.clone() for m in modes}
                print(f"[rest] host PPR push over the cut TRAIN, VALID, TEST "
                      f"({sum(t.shape[0] for t in host_tabs.values())} targets) "
                      f"{host_s:.2f}s; its cache serves the phase's trainers")
            _rest_train(tr, tag, norm, bf16=True)
            print(f"{tag} part {time.perf_counter() - t0:.1f}s")
            del tr
            torch.cuda.empty_cache()

        tag = "[rest sage tf32]"
        t0 = time.perf_counter()
        tr = _flagship_trainer(g, epochs=2, tag=tag, data_dir=tmp,
                               matmul_precision="tensorfloat32")
        tr._ensure_tables(TRAIN)
        tr._ensure_caches(TRAIN)
        batch = _train_batch(tr, 0)
        loss_t, grads_t, signs_t = _loss_grads(tr, batch, 7)
        with _f32_model(tr):
            loss_f, grads_f, signs_f = _loss_grads(tr, batch, 7)
        err, name = _grad_error(grads_t, grads_f)
        l2, name_l2 = max(((grads_t[k] - grads_f[k]).norm().item()
                           / max(grads_f[k].norm().item(), 1e-30), k) for k in grads_f)
        flips = sum(int((a != b).sum()) for a, b in zip(signs_t, signs_f))
        _detail(f"{tag} first step against the f32 model of the same weights (no "
              f"bound): loss {loss_t:.7f} vs {loss_f:.7f} (rel "
              f"{abs(loss_t - loss_f) / abs(loss_f):.2e}); worst gradient {err:.2e} "
              f"of its max ({name}), worst relative L2 {l2:.2e} ({name_l2}); relu "
              f"inputs on the other side of 0: {flips} of "
              f"{sum(a.numel() for a in signs_f)}")
        tr.trace_dir = os.path.join(tmp, "trace")
        _rest_train(tr, tag, "rw", bf16=True)
        _check_trace(tr.trace_dir, "[rest trace]")
        print(f"{tag} part {time.perf_counter() - t0:.1f}s")
        del tr, batch, grads_t, grads_f, signs_t, signs_f
        torch.cuda.empty_cache()

        tag = "[rest pairnorm]"
        t0 = time.perf_counter()
        tr = _flagship_trainer(g, epochs=1, arch={"layer_norm": "pairnorm"}, tag=tag,
                               data_dir=tmp)
        _rest_train(tr, tag, "rw")
        print(f"{tag} part {time.perf_counter() - t0:.1f}s")
        del tr
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        _rest_smooth(g)
        t1 = time.perf_counter()
        _rest_device_ppr(g, host_tabs, host_s)
        t2 = time.perf_counter()
        _rest_ingest(tmp)
        print(f"[rest] parts: smooth {t1 - t0:.1f}s, device ppr {t2 - t1:.1f}s, "
              f"ingest {time.perf_counter() - t2:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"[rest] phase {wall:.1f}s (aim 150 s, budget {REST_BUDGET_S} s)")
    if wall > REST_BUDGET_S:
        raise AssertionError(f"[rest] took {wall:.1f}s, over its {REST_BUDGET_S} s "
                             "budget")

def _flickr_power_graph():
    return _synthetic_graph("[power]", num_nodes=89_250, avg_deg=10.0, num_feat=500,
                            num_classes=7, seed=0, power_law=True)


def _arxiv_graph():
    return _synthetic_graph("[ensemble]", num_nodes=169_343, avg_deg=13.7,
                            num_feat=128, num_classes=40, seed=0, power_law=True)


def _print_plans(tr, tag):
    """Each mode's induction plan of each branch (the PPR tables are
    built for it first); returns the plans by (mode, branch)."""
    from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
    plans = {}
    for mode in (TRAIN, VALID, TEST):
        tr._ensure_tables(mode)
        for i, br in enumerate(tr.branches):
            c = br["cfg"][mode]
            plans[mode, i] = {f: getattr(c, f) for f in
                              ("method", "n_pad", "induction", "deg_cap", "hub_slots",
                               "cand_cap")}
            _detail(f"{tag} plan {MODE2STR[mode]} branch {i}: "
                    f"{json.dumps(plans[mode, i])}")
    return plans


def phase_hub_block(tr, tag):
    """The cached TRAIN blocks, induced through the hub table, against the
    ``search`` strategy (a binary search of every pair) on the same node
    tables: equal bit for bit, on subgraphs that do hold members above
    ``deg_cap``."""
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.sampling import cache as cache_mod
    from shadow_gnn_torch.sampling import induction
    cfg, cache, g = tr.branches[0]["cfg"][TRAIN], tr.caches[TRAIN][0], tr.graph[TRAIN]
    nodes = cache.nodes.long()
    t0 = time.perf_counter()
    want = induction.membership_matrix(g, nodes)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    got = cache_mod.unpack_bits(cache.adj_bits, cfg.n_pad)
    n_diff = int((got != want).sum())
    deg = g.indptr.diff()[torch.clamp(nodes, max=g.num_nodes - 1)]
    hubs = ((deg > cfg.deg_cap) & (nodes < g.num_nodes)).sum(1)
    print(f"{tag} hub-induced TRAIN blocks ({nodes.shape[0]} subgraphs, deg_cap "
          f"{cfg.deg_cap}, hub_slots {cfg.hub_slots}; {int((hubs > 0).sum())} "
          f"subgraphs hold members above deg_cap, at most {int(hubs.max())}) "
          f"against the search strategy ({t_search:.2f}s): {n_diff} entries "
          f"differ of {got.numel()}, {int(want.sum())} edges")
    if n_diff or not int(hubs.max()) or not want.sum():
        raise AssertionError("the hub-induced blocks are not the exact blocks, "
                             "or no subgraph held a hub")


class _ByWidth:
    """Stands in for a counted kernel wrapper ``fn`` (its launches still
    counted on ``counter``) and adds each call's launches to ``by_n``
    under (``name``, block width N of the adjacency, ``args[3]``)."""

    def __init__(self, fn, counter, name, by_n):
        self.fn, self.counter, self.name, self.by_n = fn, counter, name, by_n

    launches = property(lambda self: self.counter.launches,
                        lambda self, v: setattr(self.counter, "launches", v))
    launches_bf16 = property(lambda self: self.counter.launches_bf16,
                             lambda self, v: setattr(self.counter, "launches_bf16", v))

    def __call__(self, *args, **kw):
        before = self.counter.launches + self.counter.launches_bf16
        out = self.fn(*args, **kw)
        key = (self.name, int(args[3].shape[-1]))
        self.by_n[key] = (self.by_n.get(key, 0) + self.counter.launches
                          + self.counter.launches_bf16 - before)
        return out


def _gat_launches_by_width(by_n):
    """B2 and B3 launches recorded by block width within the block."""
    from shadow_gnn_torch.ops import gat
    return _Swap((gat, "_forward", _ByWidth(gat._forward, gat.gat_attention, "B2",
                                            by_n)),
                 (gat, "gat_attention_bwd", _ByWidth(gat.gat_attention_bwd,
                                                     gat.gat_attention_bwd, "B3",
                                                     by_n)))


def _step_fn(tr, seed=5):
    """``step(i)``: one TRAIN step on the mode's i-th batch (wrapping
    around) as ``Trainer._run_batches`` runs it: every uncached branch
    sampled and induced (khop picks from a generator seeded with
    ``seed``), then forward, backward, clip and Adam.  The model must be
    in training mode."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.train.pipeline import EpochRNG
    b = tr.batch_size
    rng = EpochRNG.from_seed(seed, tr.device)
    if tr.task == "link":
        # the batches of one epoch's arrays: edges and negatives, [M, 2]
        nb, roots, rows, labels, w = tr._epoch_arrays(TRAIN)

        def step(i):
            sl = slice((i % nb) * b, (i % nb + 1) * b)
            with torch.no_grad():
                batches, feats = tr._sample_branch_batches(
                    TRAIN, torch.as_tensor(roots[sl], device="cuda"),
                    torch.as_tensor(rows[sl], device="cuda"), rng.sample)
            tr._train_step(batches, feats,
                           torch.as_tensor(labels[sl].astype(np.float32), device="cuda"),
                           torch.as_tensor(w[sl], device="cuda"), rng)
        return step
    ent = np.asarray(tr.entity_set[TRAIN])

    def step(i):
        lo = (i * b) % (ent.size - b + 1)
        labels = torch.as_tensor(tr.label_np[ent[lo:lo + b]].astype(np.int64),
                                 device="cuda")
        with torch.no_grad():
            batches, feats = tr._sample_branch_batches(
                TRAIN, torch.as_tensor(ent[lo:lo + b, None], device="cuda"),
                torch.arange(lo, lo + b, device="cuda")[:, None], rng.sample)
        tr._train_step(batches, feats, labels, torch.ones(b, device="cuda"), rng)
    return step


def _timed_steps(tr, n_steps):
    """``n_steps`` steps of :func:`_step_fn`, after one warm-up step, each
    timed with CUDA events.  Returns their median in ms and the summed
    induction overflow, read once after the steps (the split by stage is
    ``_stage_split``'s, in ``[sampled ...]``)."""
    import torch
    from shadow_gnn_torch.sampling import samplers
    overflow = [0]

    def counted(*args, **kw):
        out = induce(*args, **kw)
        overflow[0] = overflow[0] + out.overflow            # on the device
        return out

    induce, step, evs = samplers.induce, _step_fn(tr), []
    tr.model.train()
    with _Swap((samplers, "induce", counted)):
        for i in range(n_steps + 1):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            step(i)
            ev[1].record()
            evs.append(ev)
    torch.cuda.synchronize()
    tr.model.eval()
    return _median([a.elapsed_time(b) for a, b in evs[1:]]), int(overflow[0])


def _profile_steps(tr, label, wall_ms, top=True):
    """Device-busy share of 5 steps of :func:`_step_fn` (sampling
    included) against their unprofiled median ``wall_ms``."""
    step = _step_fn(tr, seed=11)
    tr.model.train()
    step(0)                                             # warm
    _profile(label, lambda i: step(i + 1), 5, wall_ms, top)
    tr.model.eval()


def phase_power_law(graph, profile=False):
    """The flagship SAGE-3 (f32, packed) on the power-law flickr-scale
    graph: the plans (TRAIN must take hub slots), cached serving against
    the plain versions and against uncached serving, the hub-induced
    blocks against the search strategy, 1 epoch of ``train()`` through
    B1a/B1b, the TRAIN cache through the BFS kernel against the plain
    BFS's, and cold (uncached) TRAIN steps timed, then
    ``phase_sampled("power")``.  Returns (the launches, the BFS kernel's
    row)."""
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_t
    tag = "[power]"
    tr = _flagship_trainer(graph, epochs=1)
    plans = _print_plans(tr, tag)
    if not plans[TRAIN, 0]["hub_slots"] > 0:
        raise AssertionError("TRAIN planned no hub slots on the power-law graph")
    reqs, p50 = phase_serve(tr, SERVE_SIZES, packed_spmm, tag)
    if profile:
        phase_profile(tr, reqs, p50, (1, 256), "power")
    launches, step_ms = phase_train(tr, reqs, packed_spmm, packed_spmm_t, tag)
    if profile:
        phase_profile_train(tr, step_ms, "power")
    phase_hub_block(tr, tag)
    bfs_row = phase_bfs_cache(tr, tag)
    phase_uncached(tr, reqs, SERVE_SIZES, packed_spmm, 0, tag)
    tr.disable_cache(TRAIN)
    cold, overflow = _timed_steps(tr, COLD_STEPS)
    print(f"[power] cold step {cold:.3f} ms (median of {COLD_STEPS} uncached TRAIN "
          f"steps, B={tr.batch_size}, CUDA events; by stage: [sampled power]), "
          f"overflow {overflow}; cached step {step_ms:.3f} ms")
    if overflow:
        raise AssertionError(f"the exact plan overflowed by {overflow}")
    if profile:
        _profile_steps(tr, "power cold TRAIN step (sampling included)", cold)
    # the cold step graphed against its eager twin
    phase_sampled("power", graph, tr)
    del tr, reqs
    torch.cuda.empty_cache()
    return launches, bfs_row


def _ensemble_trainer(g, epochs=EPOCHS, cuda_graphs=True):
    """configs/arxiv_ensemble_ppr_khop.yml at full width (GAT, 2 heads, dim
    256, 3 layers, hop augment, sum residue, mean pooling; a PPR-100 and a
    khop depth-2 budget-10 branch, softmax attention over them; batch 64,
    dropout 0.3, dropedge 0.05) on the arxiv-width power-law graph ``g``,
    TRAIN cut to 4096 nodes, VALID 1024, TEST 2048, random weights.
    ``cuda_graphs``: the Trainer's argument."""
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer
    cfg = {
        "data": {"to_undirected": True, "transductive": True},
        "architecture": {"dim": 256, "aggr": "gat", "heads": 2, "loss": "softmax",
                         "num_layers": 3, "act": "relu", "feature_augment": "hops",
                         "residue": "sum", "pooling": "mean",
                         "ensemble_act": "leakyrelu"},
        "hyperparameter": {"end": epochs, "lr": 0.001, "dropout": 0.3,
                           "dropedge": 0.05, "batch_size": 64,
                           "ensemble_dropout": "none"},
        "sampler": [{"method": "ppr", "phase": "train", "k": [100],
                     "epsilon": [1e-5]},
                    {"method": "khop", "phase": "train", "depth": [2],
                     "budget": [10]}],
    }
    t0 = time.perf_counter()
    tr = Trainer("arxiv_synth", "", _own_splits(g), parse_config(cfg), seed=0,
                 device="cuda", cuda_graphs=cuda_graphs)
    _cut_splits(tr, ((TRAIN, GAT_TRAIN), (VALID, GAT_VALID), (TEST, GAT_TEST)))
    torch.cuda.synchronize()
    widths = tuple(br["cfg"][TRAIN].n_pad for br in tr.branches)
    print(f"[ensemble] trainer {time.perf_counter() - t0:.1f}s; branches "
          f"{[br['cfg'][TRAIN].method for br in tr.branches]}, n_pad {widths}")
    if widths != ENSEMBLE_WIDTHS or tr.num_ensemble != 2:
        raise AssertionError(f"the ensemble has branches of n_pad {widths}")
    return tr


def phase_ensemble(graph, profile=False):
    """The two-branch PPR + khop GAT ensemble: plans, serving (kernels
    against plain versions; the khop picks seeded per request), the first
    TRAIN step's check, ``train()`` with B2 and B3 launched from both
    branches, and timed steps (``phase_sampled("ensemble")`` splits them
    by stage).  Returns (B2, B3 launches over ``train()``, by
    block width)."""
    import torch
    from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
    from shadow_gnn_torch.train import pipeline
    tag = "[ensemble]"
    tr = _ensemble_trainer(graph)
    _print_plans(tr, tag)
    by_n, tally = {}, {}

    def tallied(*args, **kw):
        # counts on the host only: a call may run under a graph's capture,
        # which must neither read a device value nor keep one it replaces
        out = sample_subgraphs(*args, **kw)
        tally[args[0].method] = tally.get(args[0].method, 0) + out.nodes.shape[0]
        return out

    sample_subgraphs = pipeline.sample_subgraphs
    with _gat_launches_by_width(by_n), _Swap((pipeline, "sample_subgraphs", tallied)):
        reqs, p50 = phase_serve(tr, GAT_SIZES, gat_attention, tag)
        serve_n = dict(by_n)
        by_n.clear()
        launches, step_ms = phase_train(tr, reqs, gat_attention, gat_attention_bwd,
                                        tag)
    _detail(f"{tag} B2/B3 launches by block width (Python calls: eager steps, "
          f"warm-ups and captures): serving {serve_n}; the first step's checks and "
          f"train() {by_n}; subgraphs sampled by sampler in those calls {tally} "
          f"(the overflow: the timed steps' line and [sampled ensemble])")
    want = {(k, n) for k in ("B2", "B3") for n in ENSEMBLE_WIDTHS}
    if not all(by_n.get(key, 0) > 0 for key in want) or not all(
            serve_n.get(("B2", n), 0) > 0 for n in ENSEMBLE_WIDTHS):
        raise AssertionError("B2 / B3 did not launch from both branches")
    timed, overflow = _timed_steps(tr, COLD_STEPS)
    print(f"{tag} step median {timed:.3f} ms over {COLD_STEPS} TRAIN steps "
          f"(sampling included; train()'s model-step median {step_ms:.3f} ms; by "
          f"stage: [sampled ensemble]); khop overflow {overflow}")
    if profile:
        phase_profile(tr, reqs, p50, (1, 128), "ensemble")
        _profile_steps(tr, "ensemble TRAIN step (sampling included)", timed)
    phase_infer_ensemble(tr)
    phase_sampled("ensemble", graph, tr)
    del tr, reqs
    torch.cuda.empty_cache()
    return launches, by_n



def _n_batches(tr, modes):
    return sum(-(-len(tr.entity_set[m]) // tr.batch_size) for m in modes)


def _check_full(tr, mat, modes, width, tag, unit_rows=False):
    """A full-graph matrix of ``predict_full`` / ``embed_full``: [num_nodes,
    width], finite, rows of the modes' nodes summing to 1 (probabilities)
    or of norm 1 (embeddings), every other row zero."""
    import numpy as np
    covered = np.zeros(tr.num_nodes, bool)
    for m in modes:
        covered[np.asarray(tr.entity_set[m])] = True
    sums = (np.linalg.norm(mat[covered], axis=1) if unit_rows
            else mat[covered].sum(1))
    if not (mat.shape == (tr.num_nodes, width) and np.isfinite(mat).all()
            and np.allclose(sums, 1.0, atol=1e-5) and not mat[~covered].any()):
        raise AssertionError(f"{tag} a bad full-graph matrix")
    return int(covered.sum())


def _timed_inference(tr, modes, fwd, per_batch, tag, model):
    """``Trainer.inference`` over ``modes`` (uncached) with ``fwd``'s
    launches counted; prints the seconds of each evaluation pass and the
    nodes per second.  Returns the final stats by mode."""
    from shadow_gnn_torch import MODE2STR
    orig, secs = tr.run_epoch, {}

    def run_epoch(epoch, mode, status="running"):
        t0 = time.perf_counter()
        out = orig(epoch, mode, status)
        secs[mode] = time.perf_counter() - t0
        return out

    tr.run_epoch = run_epoch
    try:
        before = fwd.launches
        tr.inference(modes)
        got = fwd.launches - before
    finally:
        del tr.run_epoch
    want = per_batch * _n_batches(tr, modes)
    if got != want:
        raise AssertionError(f"{tag} inference launched {fwd.__name__} {got} "
                             f"times, want {want}")
    print(f"{tag} {model} inference: " + ", ".join(
        f"{MODE2STR[m]} {len(tr.entity_set[m])} nodes in {secs[m]:.3f}s "
        f"({len(tr.entity_set[m]) / secs[m]:.0f} nodes/s)" for m in modes)
        + f"; {got} {fwd.__name__} launches ({per_batch} a batch)")
    return {m: dict(tr.logger.final_stats[m]) for m in modes}


def phase_infer_flagship(tr):
    """[infer] the flagship SAGE-3 with its three caches built:
    ``predict_full`` reads them (B1a 3 times a batch, B1b never), then one
    VALID inference pass (uncached, the dense aggregation)."""
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_t
    tag, modes, t_phase = "[infer]", (TRAIN, VALID, TEST), time.perf_counter()
    if any(tr.caches[m][0] is None for m in modes):
        raise AssertionError(f"{tag} the flagship's caches are not all built")
    n_b = _n_batches(tr, modes)
    # the main path: counts at 0 just before, read just after
    packed_spmm.launches = packed_spmm_t.launches = 0
    t0 = time.perf_counter()
    pred = tr.predict_full(modes)
    secs = time.perf_counter() - t0
    launches = (packed_spmm.launches, packed_spmm_t.launches)
    n = _check_full(tr, pred, modes, tr.num_classes, tag)
    print(f"{tag} flagship predict_full: {n} nodes from the caches in {secs:.3f}s "
          f"({n / secs:.0f} nodes/s); packed_spmm {launches[0]}, packed_spmm_t "
          f"{launches[1]} launches over {n_b} batches")
    if launches != (3 * n_b, 0):
        raise AssertionError(f"{tag} predict_full launched {launches}, want "
                             f"({3 * n_b}, 0)")
    _timed_inference(tr, (VALID,), packed_spmm, 0, tag, "flagship")
    print(f"{tag} flagship part {time.perf_counter() - t_phase:.1f}s")


def phase_infer_gat(tr, graph):
    """[infer] the trained products GAT-5: its checkpoint saved through a
    Logger and reloaded (``retrain_dir``) bit for bit; ``inference`` of
    VALID and TEST on both trainers (equal stats, B2 5 times a batch);
    ``predict_full`` over the three modes against ``predict_nodes``;
    Correct & Smooth on the card over the whole graph, with and without
    the symmetric scaling, against the CPU.  Returns the prediction
    matrix, which ``phase_ring`` smooths again."""
    import tempfile

    import numpy as np
    import torch
    from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
    from shadow_gnn_torch.ops.gat import gat_attention
    from shadow_gnn_torch.postproc import cns
    from shadow_gnn_torch.train.logger import Logger
    tag, t_phase = "[infer]", time.perf_counter()
    with tempfile.TemporaryDirectory() as run_dir:
        Logger(tr.metrics, run_dir).save_checkpoint(tr.model.state_dict(),
                                                    tr.optimizer.state_dict())
        tr2 = _gat_trainer(graph, retrain_dir=run_dir)
    sd, sd2 = tr.model.state_dict(), tr2.model.state_dict()
    if sd.keys() != sd2.keys() or not all(torch.equal(sd[k], sd2[k]) for k in sd):
        raise AssertionError(f"{tag} the reloaded model is not the saved one")
    o, o2 = tr.optimizer.state_dict()["state"], tr2.optimizer.state_dict()["state"]
    if o.keys() != o2.keys() or not all(torch.equal(o[k][n], o2[k][n])
                                        for k in o for n in o[k]):
        raise AssertionError(f"{tag} the reloaded optimizer is not the saved one")
    print(f"{tag} GAT-5 reloaded through retrain_dir: {len(sd)} tensors and "
          f"{len(o)} Adam states equal bit for bit")

    # the main path: counts at 0 just before, read just after
    gat_attention.launches = 0
    got = _timed_inference(tr2, (VALID, TEST), gat_attention, 5, tag, "GAT-5 reloaded")
    want = _timed_inference(tr, (VALID, TEST), gat_attention, 5, tag, "GAT-5")
    for m in (VALID, TEST):
        a, b = got[m], want[m]
        if (a["accuracy"] != b["accuracy"]
                or abs(a["loss"] - b["loss"]) > 1e-6 * abs(b["loss"])):
            raise AssertionError(f"{tag} reloaded {MODE2STR[m]} stats {a}, the "
                                 f"original's {b}")
    print(f"{tag} reloaded = original: " + "; ".join(
        f"{MODE2STR[m]} accuracy {got[m]['accuracy']:.5f}, loss {got[m]['loss']:.7f}"
        f" (|diff| {abs(got[m]['loss'] - want[m]['loss']):.2e})" for m in (VALID, TEST)))
    del tr2
    torch.cuda.empty_cache()

    modes = (TRAIN, VALID, TEST)
    n_b = _n_batches(tr, modes)
    before = gat_attention.launches
    t0 = time.perf_counter()
    pred = tr.predict_full(modes)
    secs = time.perf_counter() - t0
    launches = gat_attention.launches - before
    n = _check_full(tr, pred, modes, tr.num_classes, tag)
    rng = np.random.default_rng(1)
    diff = 0.0
    for m in (VALID, TEST):
        ids = rng.choice(np.asarray(tr.entity_set[m]), 128, replace=False)
        diff = max(diff, float(np.abs(pred[ids] - tr.predict_nodes(ids, m)).max()))
    print(f"{tag} GAT-5 predict_full: {n} nodes (TRAIN cached, VALID and TEST "
          f"sampled) in {secs:.3f}s ({n / secs:.0f} nodes/s), {launches} "
          f"gat_attention launches over {n_b} batches; max |predict_full - "
          f"predict_nodes| over 256 VALID and TEST ids {diff:.3e}")
    if launches != 5 * n_b or diff > TOL_PROBS:
        raise AssertionError(f"{tag} predict_full: {launches} launches, "
                             f"difference {diff}")

    # C&S over the whole graph: every TRAIN label known, accuracy over
    # the cut VALID and TEST sets, which predict_full covered
    indptr, indices, lab = graph.indptr_full, graph.indices_full, graph.label_full
    node_set = {TRAIN: graph.node_set[TRAIN], VALID: tr.entity_set[VALID],
                TEST: tr.entity_set[TEST]}
    t0 = time.perf_counter()
    op_cpu, deg_cpu = cns.mean_operator(indptr, indices, "cpu")
    t_op = time.perf_counter() - t0
    op, deg = op_cpu.to("cuda"), deg_cpu.to("cuda")
    y0 = torch.as_tensor(cns.seed_matrix(pred, lab, node_set[TRAIN]))
    print(f"{tag} C&S graph: {graph.num_nodes} nodes, {op._nnz()} stored "
          f"entries of the mean operator (edges, their reverses and self loops, "
          f"duplicates summed), built on the host in {t_op:.2f}s; {pred.shape[1]} "
          f"classes")
    summary = []
    for use_norm in (False, True):
        t0 = time.perf_counter()
        acc_orig, acc_cs = cns.correct_smooth(indptr, indices, lab, node_set, [pred],
                                              use_norm, 0.8, device="cuda")
        t_call = time.perf_counter() - t0
        y0_d = y0.to("cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        y_d = cns.propagate(op, deg, y0_d, use_norm=use_norm)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms = ev[0].elapsed_time(ev[1]) / cns.N_PROP
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        y_c = cns.propagate(op_cpu, deg_cpu, y0, use_norm=use_norm)
        t_cpu = time.perf_counter() - t0
        err = float((y_d.cpu() - y_c).abs().max())
        summary.append(f"{'on' if use_norm else 'off'} {step_ms:.4f} ms, err "
                       f"{err:.1e}, VALID {acc_orig[VALID][0]:.3f}->"
                       f"{acc_cs[VALID][0]:.3f}")
        _detail(f"{tag} C&S norm_sym {use_norm}: correct_smooth on the card "
              f"{t_call:.2f}s (operator built in it); propagation "
              f"{step_ms:.4f} ms a step (CUDA events, {cns.N_PROP} steps), peak "
              f"device memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**20:.1f} "
              f"MiB above the {base / 2**30:.3f} GiB held before); the CPU "
              f"{t_cpu:.2f}s; max |card - CPU| {err:.3e} (tolerance {TOL_CS}); "
              f"accuracy before / after: VALID {acc_orig[VALID][0]:.4f} / "
              f"{acc_cs[VALID][0]:.4f}, TEST {acc_orig[TEST][0]:.4f} / "
              f"{acc_cs[TEST][0]:.4f}")
        if not err <= TOL_CS:
            raise AssertionError(f"{tag} C&S on the card and the CPU differ by {err}")
        del y_d, y0_d
    print(f"{tag} C&S {graph.num_nodes}x{pred.shape[1]} a step, norm_sym "
          f"{'; '.join(summary)} (card - CPU, TOL_CS {TOL_CS})")
    print(f"{tag} GAT-5 part {time.perf_counter() - t_phase:.1f}s")
    return pred


def phase_infer_ensemble(tr):
    """[infer] the trained arxiv ensemble: ``embed_full`` over the three
    modes with B2 launched from both branches (counted by block width),
    the post-ensemble trained on its two embedding matrices on the card
    (``ensemble_multirun``, one run), and ``inference`` of VALID and
    TEST."""
    import numpy as np
    from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
    from shadow_gnn_torch.ops.gat import gat_attention
    from shadow_gnn_torch.postproc.ens import ensemble_multirun
    tag, modes, t_phase = "[infer]", (TRAIN, VALID, TEST), time.perf_counter()
    n_b = _n_batches(tr, modes)
    # the main path (graph replays): counts at 0 just before, read just after
    gat_attention.launches = 0
    t0 = time.perf_counter()
    embs = tr.embed_full(modes)
    secs = time.perf_counter() - t0
    launches = gat_attention.launches
    n = [_check_full(tr, e, modes, tr.model_cfg.dim, tag, unit_rows=True)
         for e in embs][0]
    # the block widths of each launch, seen by Python only on eager steps:
    # the TEST rows again with the graphs paused, equal bit for bit
    by_n, n_test = {}, _n_batches(tr, (TEST,))
    with _gat_launches_by_width(by_n), tr.step_graphs.paused():
        test = tr.embed_full((TEST,))
    ids = np.asarray(tr.entity_set[TEST])
    same = all(np.array_equal(a[ids], b[ids]) for a, b in zip(embs, test))
    _detail(f"{tag} ensemble embed_full TEST rows eagerly: by block width {by_n} "
            f"over {n_test} batches, equal to the graphed ones: {same}")
    print(f"{tag} ensemble embed_full: {len(embs)} branches, {n} nodes in "
          f"{secs:.3f}s ({n / secs:.0f} nodes/s); gat_attention {launches} launches "
          f"over {n_b} batches")
    if (len(embs) != 2 or launches != 6 * n_b or not same
            or any(by_n.get(("B2", w), 0) != 3 * n_test for w in ENSEMBLE_WIDTHS)):
        raise AssertionError(f"{tag} embed_full did not launch B2 3 times a batch "
                             f"from each branch, or its eager TEST rows differ")
    arch = {"dim": 64, "act": "leakyrelu", "loss": "softmax"}
    hp = {"lr": 0.01, "batch_size": 256, "end": 5, "dropout": 0.0}
    t0 = time.perf_counter()
    acc = ensemble_multirun(tr.entity_set, {"ppr+khop": [embs]}, tr.label_np, arch,
                            hp, repeat=1, device="cuda")
    secs = time.perf_counter() - t0
    print(f"{tag} post-ensemble (dim {arch['dim']}, {hp['end']} epochs of "
          f"{len(tr.entity_set[TRAIN]) // hp['batch_size']} steps, one run) in "
          f"{secs:.2f}s: " + ", ".join(f"{MODE2STR[m]} {acc[m][0]:.4f}" for m in modes))
    if not all(len(acc[m]) == 1 and 0.0 <= acc[m][0] <= 1.0 for m in modes):
        raise AssertionError(f"{tag} post-ensemble accuracies {acc}")
    if not acc[TEST][0] > 2.0 / tr.num_classes:
        raise AssertionError(f"{tag} the post-ensemble learned nothing: {acc}")
    _timed_inference(tr, (VALID, TEST), gat_attention, 6, tag, "ensemble")
    print(f"{tag} ensemble part {time.perf_counter() - t_phase:.1f}s")


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _collab_graph():
    """scripts/cold_bench.py's ``collab_lead`` shape: 235,000 nodes, avg
    deg 10, 128 features, seed 0, the synthetic link splits (VALID and
    TEST positives held out of the message graph)."""
    return _synthetic_graph("[link]", num_nodes=235_000, avg_deg=10.0, num_feat=128,
                            seed=0, task="link")


def _link_trainer(g, epochs=EPOCHS, cuda_graphs=True):
    """configs/collab_sage_pprst_leaderboard.yml at full width (SAGE, 5
    layers, dim 256, elu, sigmoid loss, DRNL one-hots concatenated, concat
    residue, sort-25 pooling; ppr_st k 200, threshold 0.01, eps 1e-6;
    batch 16, dropout 0.25, dropedge 0.1, lr 2e-5, 10% of TRAIN an epoch)
    on the collab-shape graph ``g``, ``packed_adj`` on; TRAIN positives
    cut to ``LINK_TRAIN_POS`` edges of the message graph (a seeded
    permutation; the trainer draws as many negatives), VALID and TEST the
    synthetic held-out sets; random weights from seed 0.  Its PPR tables
    come from the power iteration on the card (``--device_ppr device``):
    the host push over every node took 417-446 s of the script's time
    limit, and ``[rest]`` holds the push and the device tables against
    each other.  ``cuda_graphs``: the Trainer's argument."""
    import dataclasses
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer
    cfg = {
        "data": {"to_undirected": True, "transductive": True},
        "architecture": {"dim": 256, "aggr": "sage", "loss": "sigmoid",
                         "num_layers": 5, "act": "elu", "feature_augment": "drnls",
                         "feature_augment_ops": "concat", "residue": "concat",
                         "pooling": "sort-25"},
        "hyperparameter": {"end": epochs, "lr": 2e-5, "dropout": 0.25,
                           "dropedge": 0.1, "batch_size": 16,
                           "percent_per_epoch": {"train": 0.1, "valid": 1, "test": 1}},
        "sampler": [{"method": "ppr_st", "phase": "train", "k": [200],
                     "threshold": [0.01], "epsilon": [1e-6]}],
    }
    t0 = time.perf_counter()
    src = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr_full))
    upper = src < g.indices_full
    pool = np.stack([src[upper], g.indices_full[upper]], 1).astype(np.int64)
    pick = np.random.default_rng(0).permutation(pool.shape[0])[:LINK_TRAIN_POS]
    edge_set = dict(g.edge_set)
    edge_set[TRAIN] = {"pos": pool[pick]}
    tr = Trainer("collab", "", dataclasses.replace(g, edge_set=edge_set),
                 parse_config(cfg), seed=0, device="cuda", packed_adj=True,
                 use_device_ppr=True, cuda_graphs=cuda_graphs)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tr.model.parameters())
    print(f"[link] trainer {time.perf_counter() - t0:.1f}s; {n_params} parameters, "
          f"nn_pool {tuple(tr.model.res_pool.nn_pool.weight.shape)}; metric "
          f"{tr.metrics.name}")
    return tr


def _kernel_counts():
    """Every kernel level's launch counter, by name: (wrapper, attribute)."""
    from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_t
    return {"B1a": (packed_spmm, "launches"), "B1b": (packed_spmm_t, "launches"),
            "B1c": (packed_spmm, "launches_bf16"),
            "B1c transposed": (packed_spmm_t, "launches_bf16"),
            "B2": (gat_attention, "launches"), "B2b": (gat_attention, "launches_bf16"),
            "B3": (gat_attention_bwd, "launches"),
            "B3b": (gat_attention_bwd, "launches_bf16")}


@contextlib.contextmanager
def _no_kernel_launches(what, tag="[link]"):
    """Every kernel count set to 0 on entry; any launch within the block
    fails it."""
    counts = _kernel_counts()
    for fn, attr in counts.values():
        setattr(fn, attr, 0)
    yield
    got = {k: getattr(fn, attr) for k, (fn, attr) in counts.items()}
    print(f"{tag} kernel launches over {what}: {got}")
    if any(got.values()):
        raise AssertionError(f"{what} launched a packed or GAT kernel: {got}")


def _link_sort_order(res_pool, args):
    """The sort pool's ranking of each subgraph's nodes (its first k
    places), from ResPool's inputs."""
    import torch
    from shadow_gnn_torch.nn.respool import f_residue
    feats_l, _, node_mask = args[:3]
    block = feats_l[-1] if res_pool.type_res == "none" else f_residue(feats_l,
                                                                      res_pool.type_res)
    key = torch.where(node_mask, block[..., -1].detach(), -1e30)
    return torch.sort(-key, dim=-1, stable=True)[1][:, :res_pool.sort_k]


def _link_step(model, cfg, sampler_cfg, graph, tables, roots, rows, u, feat_tab,
               labels):
    """One TRAIN batch of the link model on ``graph``'s device, sampled with
    the uniforms ``u``, forward and backward at dropout and dropedge 0
    (eval mode): (batch, loss, gradients, the sort pool's ranking)."""
    import torch
    from shadow_gnn_torch.sampling.samplers import sample_subgraphs
    from shadow_gnn_torch.train.pipeline import weighted_loss_fn
    with torch.no_grad():
        batch = sample_subgraphs(sampler_cfg, graph, roots, rows, tables, u=u)
    feat = feat_tab[torch.clamp(batch.nodes, max=graph.num_nodes - 1)]
    order = []
    hook = model.res_pool.register_forward_pre_hook(
        lambda m, a: order.append(_link_sort_order(m, a)))
    try:
        model.eval()
        model.zero_grad(set_to_none=True)
        logits, _ = model(batch, feat, None, 0, True)
        loss = weighted_loss_fn(cfg, logits, labels, torch.ones_like(labels[:, 0]))
        loss.backward()
    finally:
        hook.remove()
    return batch, loss.item(), {k: p.grad.detach().clone()
                                for k, p in model.named_parameters()}, order[0]


def _link_card_vs_cpu(tr, tag):
    """One TRAIN batch (8 positives, 8 random pairs) through the port on
    the card and on the CPU, with the same parameters, roots and ppr_st
    uniforms, dropout and dropedge 0: the node tables, blocks, targets and
    DRNL labels equal bit for bit; the loss within 1e-5 relative and each
    gradient within 1e-4 of its max.  The sort pool's ranking is a
    discontinuity: the rank swaps between the two sides are counted, and
    the loss and gradients are held on the first of ``LINK_CHECK_TRIES``
    batches without a swap."""
    import copy
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.data.graph import DeviceGraph
    from shadow_gnn_torch.sampling.samplers import PPRTables
    t0 = time.perf_counter()
    cfg = tr.branches[0]["cfg"][TRAIN]
    tab = tr.tables[TRAIN][0]
    g_cpu = DeviceGraph.from_csr(*tr._host_adj[TRAIN], "cpu")
    model_cpu = copy.deepcopy(tr.model).cpu()
    feat_cpu = tr.feat_tab.cpu()
    b, n = tr.batch_size, tr.num_nodes
    pos = tr.entity_set[TRAIN]["pos"]
    rng = np.random.default_rng(1)
    labels = torch.as_tensor(np.repeat([1.0, 0.0], [b // 2, b - b // 2])[:, None],
                             dtype=torch.float32)
    for attempt in range(LINK_CHECK_TRIES):
        roots = np.concatenate([pos[attempt * (b // 2):(attempt + 1) * (b // 2)],
                                rng.integers(0, n, (b - b // 2, 2))]).astype(np.int64)
        roots_d = torch.as_tensor(roots, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(attempt)
        u = torch.clamp(torch.rand((2 * b, tab.neighs.shape[1]), generator=gen,
                                   device="cuda") * (1.0 - 1e-12) + 1e-12, min=1e-12)
        flat = roots_d.reshape(-1)
        tab_cpu = PPRTables(tab.neighs[flat].cpu(), tab.scores[flat].cpu())
        rows_cpu = torch.arange(2 * b).reshape(b, 2)
        gb, g_loss, g_grads, g_order = _link_step(
            tr.model, tr.model_cfg, cfg, tr.graph[TRAIN], tab, roots_d, roots_d, u,
            tr.feat_tab, labels.to("cuda"))
        cb, c_loss, c_grads, c_order = _link_step(
            model_cpu, tr.model_cfg, cfg, g_cpu, tab_cpu, torch.as_tensor(roots),
            rows_cpu, u.cpu(), feat_cpu, labels)
        for f in ("nodes", "adj", "targets", "drnl", "node_mask"):
            if not torch.equal(getattr(gb, f).cpu(), getattr(cb, f)):
                raise AssertionError(f"the card's batch differs from the CPU's in {f}")
        swaps = int((g_order.cpu() != c_order).sum())
        rel = abs(g_loss - c_loss) / abs(c_loss)
        err, name = _grad_error({k: v.cpu() for k, v in g_grads.items()}, c_grads)
        print(f"{tag} card vs CPU, batch {attempt}: nodes, blocks, targets and DRNL "
              f"equal ({int(gb.size.sum())} nodes, {int(gb.adj.sum())} edges, DRNL "
              f"max {int(gb.drnl[gb.node_mask].max())}); sort-pool rank swaps "
              f"{swaps} of {g_order.numel()}; loss {g_loss:.7f} vs {c_loss:.7f} "
              f"(rel {rel:.2e}); worst gradient error {err:.2e} of its max ({name})"
              + (" (not held: ranks swapped)" if swaps else ""))
        if swaps:
            continue
        if rel > 1e-5 or err > 1e-4:
            raise AssertionError("the card's link step differs from the CPU's")
        break
    else:
        raise AssertionError(f"every one of {LINK_CHECK_TRIES} batches swapped ranks")
    tr.model.zero_grad(set_to_none=True)
    print(f"{tag} card vs CPU check {time.perf_counter() - t0:.1f}s")


def _time_optimizer(tr, tag):
    """The clip and Adam update of one step (the gradients of the last
    step in place), timed with CUDA events over 10 calls, beside the
    least time for their bytes: Adam reads a parameter, its gradient and
    two moments and writes three, the clip reads the gradients twice and
    writes them once (40 bytes a parameter)."""
    import torch
    from shadow_gnn_torch.train.pipeline import CLIP_NORM, clip_grad_global_norm_
    params = list(tr.model.parameters())
    n = sum(p.numel() for p in params)

    def update():
        clip_grad_global_norm_(params, CLIP_NORM)
        tr.optimizer.step()

    for _ in range(2):
        update()
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    for _ in range(10):
        update()
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / 10
    bound = 40.0 * n / HBM_BYTES_PER_S * 1e3
    print(f"{tag} clip + Adam over {n} parameters ({tr.model.res_pool.nn_pool.weight.numel()}"
          f" of them nn_pool's): {ms:.3f} ms a step (CUDA events, 10 calls), bound "
          f"{bound:.3f} ms (40 bytes a parameter at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")


def phase_link(graph, profile=False):
    """The collab SAGE-5 ppr_st + DRNL + sort-25 link model on the
    collab-shape graph: the shared PPR push and the plans, the card
    against the CPU on one batch, ``Trainer.train()`` (2 epochs) and
    ``inference`` of VALID and TEST (edges/s; the final stats again) with
    no packed or GAT kernel launched, then 10 timed TRAIN steps (sampling
    included) and their device-busy share."""
    import numpy as np
    import torch
    from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
    tag = "[link]"
    card = _card()
    tr = _link_trainer(graph)
    calls = []
    compute_ppr = tr._compute_ppr
    tr._compute_ppr = lambda *a, **kw: calls.append(a[2]) or compute_ppr(*a, **kw)
    t0 = time.perf_counter()
    try:
        plans = _print_plans(tr, tag)
    finally:
        del tr._compute_ppr
    ppr_s = time.perf_counter() - t0
    tab = tr.tables[TRAIN][0]
    print(f"{tag} PPR tables: {len(calls)} device power iteration over "
          f"{tr.num_nodes} nodes at "
          f"k_tab {calls[0] if calls else None}, shared by TRAIN, VALID and TEST, "
          f"with the plans: {ppr_s:.1f}s ({card})")
    if (calls != [LINK_K_TAB] or not tab is tr.tables[VALID][0] is tr.tables[TEST][0]
            or tuple(tab.neighs.shape) != (tr.num_nodes, LINK_K_TAB)):
        raise AssertionError(f"the PPR tables are not one shared push: {calls}")
    if ([plans[m, 0]["method"] for m in (TRAIN, VALID, TEST)] != ["ppr_st", "ppr", "ppr"]
            or plans[TRAIN, 0]["n_pad"] != LINK_N_PAD):
        raise AssertionError(f"unexpected plans {plans}")
    _link_card_vs_cpu(tr, tag)

    steps, losses = [], []
    train_step = tr._graph_train_step

    def timed_step(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = train_step(*args, **kw)
        ev[1].record()
        steps.append(ev)
        losses.append(out[0])
        return out

    tr._graph_train_step = timed_step
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        # the main path: counts at 0 just before, read just after
        with _no_kernel_launches("train()"):
            t0 = time.perf_counter()
            final = tr.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del tr._graph_train_step
    peak = torch.cuda.max_memory_allocated()
    n_epochs = int(tr.params_train["end"])
    nb = -(-int(np.ceil(0.1 * 2 * LINK_TRAIN_POS)) // tr.batch_size)
    if len(steps) != n_epochs * nb:
        raise AssertionError(f"{len(steps)} TRAIN steps, want {n_epochs * nb}")
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError("a training loss is not finite")
    if not all(np.isfinite(st["loss"]) and 0.0 <= st["hits50"] <= 1.0
               for st in final.values()):
        raise AssertionError(f"final stats out of range: {final}")
    moved = sum(not torch.equal(p0[k], v) for k, v in tr.model.state_dict().items())
    if moved != len(p0):
        raise AssertionError(f"training moved {moved} of {len(p0)} parameters")
    step_ms = [a.elapsed_time(b) for a, b in steps]
    print(f"{tag} train(): {n_epochs} epochs of {nb} TRAIN steps (B={tr.batch_size} "
          f"edges, n_pad {LINK_N_PAD}) in {wall:.2f}s; step (CUDA events) median "
          f"{_median(step_ms):.3f} ms, epoch-1 median {_median(step_ms[nb:]):.3f} ms; "
          f"peak device memory {peak / 2**30:.2f} GiB; {moved} parameters moved; "
          f"final " + "; ".join(f"{MODE2STR[m]} loss {st['loss']:.5f} hits50 "
                                f"{st['hits50']:.5f}" for m, st in final.items())
          + f" ({card})")

    # inference of the trained model: the final VALID and TEST stats again
    n_eval = sum(len(tr.entity_set[m]["pos"]) + len(tr.entity_set[m]["neg"])
                 for m in (VALID, TEST))
    with _no_kernel_launches("inference"):
        t0 = time.perf_counter()
        summary = tr.inference()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    print(f"{tag} inference VALID + TEST: {n_eval} edges in {secs:.3f}s, "
          f"{n_eval / secs:.0f} edges/s ({card}); {summary}")
    again = tr.logger.final_stats
    if any(again[m]["hits50"] != final[m]["hits50"]
           or abs(again[m]["loss"] - final[m]["loss"]) > 1e-6 * abs(final[m]["loss"])
           for m in (VALID, TEST)):
        raise AssertionError("inference does not reproduce the final stats")

    timed, overflow = _timed_steps(tr, COLD_STEPS)
    print(f"{tag} step median {timed:.3f} ms over {COLD_STEPS} TRAIN steps "
          f"(sampling included, CUDA events; by stage: [sampled link]); overflow "
          f"{overflow}; {tr.batch_size / timed * 1e3:.0f} edges/s ({card})")
    if overflow:
        raise AssertionError(f"the exact plan overflowed by {overflow}")
    _profile_steps(tr, "link TRAIN step (sampling included)", timed, top=profile)
    _time_optimizer(tr, tag)
    # the BFS kernel at the link shape (DRNL: S = 2), then the step graphed
    roots = tr._epoch_arrays(TRAIN)[1]
    roots_d = torch.as_tensor(roots[:tr.batch_size], device="cuda")
    with torch.no_grad():
        batch = tr._sample_branch_batches(TRAIN, roots_d, roots_d,
                                          torch.Generator(device="cuda"))[0][0]
    ms, _, bound_ms, _ = _bfs_time(batch, 2, tag)
    print(f"{tag} bfs_hops (DRNL, B={batch.adj.shape[0]}, S=2) {ms:.4f} ms, bound "
          f"{bound_ms:.5f}")
    phase_sampled("link", graph, tr)

    del tr
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# [parallel]: partitioned training (shadow_gnn_torch/parallel)
# --------------------------------------------------------------------------

# (backend, world, device) of the phase's runs on one card: NCCL at world
# 1 (it cannot hold two ranks of a group on one card) and gloo at world 4,
# every rank on cuda:0 (gloo stages CUDA tensors through host memory)
GRAPHS_BUDGET_S = 180           # the phase aims at 120 s
GRAPH_WINDOW = 16               # TRAIN steps of a timed window
GRAPH_ROUNDS = 3                # rounds of eager, graphed, graphed, eager windows
GRAPH_REQS = 10                 # timed requests of each size and trainer, in turns
# graphed against eager where they are not bit for bit (cuBLAS may pick
# another algorithm under capture): (loss rel, each parameter and Adam
# state of its max, probabilities and embeddings abs)
GRAPH_TOLS = (1e-6, 1e-6, 1e-6)


def _graph_twin(kind, g, data_dir, cuda_graphs):
    """A 1-epoch trainer of the [graphs] model ``kind`` ("flagship",
    "flagship bf16" or "gat"), its PPR tables through the cache in
    ``data_dir``."""
    if kind == "gat":
        return _gat_trainer(g, epochs=1, data_dir=data_dir, cuda_graphs=cuda_graphs)
    precision = {"matmul_precision": "bfloat16"} if kind == "flagship bf16" else {}
    return _flagship_trainer(g, epochs=1, tag=f"[graphs {kind}]", data_dir=data_dir,
                             cuda_graphs=cuda_graphs, **precision)


def _counter_names(counters):
    from shadow_gnn_torch.ops import packed
    from shadow_gnn_torch.parallel import collectives
    return [f"collectives.{n}" if h is collectives.stats else
            f"{'packed_spmm' if h is packed.packed_spmm.launches_by_norm else 'packed_spmm_t'}"
            f"_{n}" if isinstance(h, dict) else f"{h.__name__}.{n}" for h, n in counters]


def _graph_epoch(tr):
    """TRAIN epoch 0 and its VALID pass through ``run_epoch``: each pass's
    (name, per-batch losses, predictions) and the launch counts over both."""
    import torch
    from shadow_gnn_torch import MODE2STR, TRAIN, VALID
    from shadow_gnn_torch.train import graphs
    passes, run_batches = [], tr._run_batches

    def recorded(mode, *args):
        out = run_batches(mode, *args)
        passes.append((MODE2STR[mode].upper(), *out[:2]))
        return out

    counters = graphs.launch_counters()
    before = graphs.counter_values(counters)
    tr._run_batches = recorded
    try:
        tr.run_epoch(0, TRAIN)
        tr.run_epoch(0, VALID)
        torch.cuda.synchronize()
    finally:
        del tr._run_batches
    after = graphs.counter_values(counters)
    return passes, {name: a - b for name, a, b in
                    zip(_counter_names(counters), after, before) if a != b}


def _graph_diff(got, want, scale=False):
    """(bit for bit, max |got - want|, over max |want| with ``scale``)."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shapes {got.shape} and {want.shape}")
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if scale:
        err /= max(float(np.abs(want).max()), 1e-30)
    return bool(np.array_equal(got, want)), err


def _window_profile(fn, n):
    """torch.profiler over ``fn()`` (``n`` steps): (device-busy ms, device
    kernels, CUDA runtime calls of the host) per step; the busy ms is
    None where the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    api = [e for e in prof.events()
           if e.device_type == DeviceType.CPU and e.name.startswith("cuda")]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / n
    return (busy or None), len(kern) / n, len(api) / n


def _twin_check(tag, p_e, p_g, eager, graphed, state, serve):
    """Graphed against eager twin: each pass's losses and predictions
    ((name, losses, predictions) of each), with ``state`` every parameter
    and Adam state, and the requests' ``serve`` (``_twin_serving``); bit
    for bit, else within ``GRAPH_TOLS`` (the errors to the log).  Returns
    (bit for bit, the errors by name)."""
    bits, errs = [], {}
    for (what, le, pe), (_, lg, pg) in zip(p_e, p_g):
        for name, got, want, scale in ((f"{what} losses", lg, le, True),
                                       (f"{what} predictions", pg, pe, False)):
            same, errs[name] = _graph_diff(got, want, scale)
            bits.append(same)
    diffs = {"serving": serve}
    if state:
        sd_e, sd_g = eager.model.state_dict(), graphed.model.state_dict()
        o_e = eager.optimizer.state_dict()["state"]
        o_g = graphed.optimizer.state_dict()["state"]
        diffs["state"] = [_graph_diff(sd_g[k].cpu(), sd_e[k].cpu(), True)
                          for k in sd_e] + [
            _graph_diff(o_g[k][n].cpu(), o_e[k][n].cpu(), True)
            for k in o_e for n in o_e[k]]
    for name, d in diffs.items():
        if d:
            bits += [same for same, _ in d]
            errs[name] = max(err for _, err in d)
    if not all(bits):
        _detail(f"{tag} graphed vs eager, not bit for bit: {errs}")
        tol_loss, tol_state, tol_probs = GRAPH_TOLS
        if not (max(v for k, v in errs.items() if k.endswith("losses")) <= tol_loss
                and errs.get("state", 0.0) <= tol_state
                and max(v for k, v in errs.items()
                        if k.endswith("predictions") or k == "serving") <= tol_probs):
            raise AssertionError(f"{tag} graphed and eager differ: {errs}")
    return all(bits), errs


def _twin_serving(eager, graphed, reqs, tag):
    """The first request of each size in ``reqs`` on both twins, three
    times on the graphed one (its warm-up, capture and a replay), whose
    bucket must have replayed.  Returns ``_graph_diff`` of the served
    probabilities and embeddings, graphed against eager."""
    import numpy as np
    from shadow_gnn_torch import TEST
    from shadow_gnn_torch.sampling.induction import bucket_cap
    diffs = []
    for s, ids in ((s, r[0]) for s, r in reqs.items()):
        want = (eager.predict_nodes(ids), np.stack(eager.embed_nodes(ids)))
        for _ in range(3):
            got = (graphed.predict_nodes(ids), np.stack(graphed.embed_nodes(ids)))
            diffs += [_graph_diff(a, b) for a, b in zip(got, want)]
        key = ("serve", TEST, 8 if s <= 8 else bucket_cap(s), graphed._cache_sig(TEST))
        if not graphed.step_graphs.replays[key] > 0:
            raise AssertionError(f"{tag} the {s}-id bucket replayed no graph")
    return diffs


def _twin_timing(tag, what, eager, graphed, window, rounds, n, reqs):
    """In turns: ``rounds`` rounds of eager, graphed, graphed, eager
    windows (``window(tr, k)``: ``n`` steps, host clock to a synchronise),
    one profiled window each (``_window_profile``), then the requests of
    ``reqs`` alternating; each twin's line to the log.  Returns the
    summary's timing text."""
    import torch
    from shadow_gnn_torch import TEST
    step = {id(eager): [], id(graphed): []}
    for k in range(rounds):
        for tr in (eager, graphed, graphed, eager):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            window(tr, k)
            torch.cuda.synchronize()
            step[id(tr)].append((time.perf_counter() - t1) * 1e3 / n)
    prof = {id(tr): _window_profile(lambda tr=tr: window(tr, rounds), n)
            for tr in (eager, graphed)}
    lat = {(id(tr), s): [] for tr in (eager, graphed) for s in reqs}
    for s, batch in reqs.items():
        for i, ids in enumerate(batch):
            for tr in ((eager, graphed) if i % 2 == 0 else (graphed, eager)):
                t1 = time.perf_counter()
                tr.predict_nodes(ids, TEST)
                lat[id(tr), s].append((time.perf_counter() - t1) * 1e3)
    med = {i: _median(v) for i, v in step.items()}
    sizes = list(reqs)
    for tr, name in ((eager, "eager"), (graphed, "graphed")):
        busy, kern, api = prof[id(tr)]
        share = "not measured" if busy is None else f"{busy / med[id(tr)]:.3f}"
        busy_s = "not measured" if busy is None else f"{busy:.3f}"
        _detail(f"{tag} {name}: {what} median {med[id(tr)]:.3f} ms (windows "
                + ", ".join(f"{x:.3f}" for x in step[id(tr)])
                + f"), device busy {busy_s} ms a step (share {share}), {kern:.0f} "
                f"device kernels and {api:.0f} host CUDA calls a step"
                + ("; request p50 ms by ids " + ", ".join(
                    f"{s} {_median(lat[id(tr), s]):.3f}" for s in sizes)
                   if sizes else ""))
    e, g = id(eager), id(graphed)
    return (f"{what} ms eager {med[e]:.3f} / graphed {med[g]:.3f}, busy share "
            + " / ".join("n/m" if prof[i][0] is None else f"{prof[i][0] / med[i]:.2f}"
                         for i in (e, g))
            + ", host calls " + " / ".join(f"{prof[i][2]:.0f}" for i in (e, g))
            + (f"; p50 ms {sizes[0]} id {_median(lat[e, sizes[0]]):.2f} / "
               f"{_median(lat[g, sizes[0]]):.2f}, {sizes[-1]} ids "
               f"{_median(lat[e, sizes[-1]]):.2f} / {_median(lat[g, sizes[-1]]):.2f}"
               if sizes else ""))


def phase_graphs(g, kinds):
    """[graphs]: for each model of ``kinds``, an eager twin
    (``cuda_graphs=False``) and a graphed trainer from the same seed: TRAIN
    epoch 0 and its VALID pass (per-step losses and predictions, the final
    parameters and Adam state, every kernel's launches), then serving at
    every size, held graphed against eager bit for bit (``GRAPH_TOLS``
    where not, printed); the graphed trainer must have replayed a graph
    for every TRAIN and eval step but its key's first (the warm-up) and
    for every serving bucket.  Then, in turns in this call: the TRAIN
    step (``GRAPH_ROUNDS`` rounds of eager, graphed, graphed, eager
    windows of ``GRAPH_WINDOW`` steps, host clock to a synchronise), its
    device-busy share and host CUDA calls (torch.profiler, one window
    each), the request p50 by size, the capture seconds and the graph
    pool.  Returns the phase's seconds."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.train.pipeline import EpochRNG
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graphs_")
    try:
        for kind in kinds:
            tag = f"[graphs {kind}]"
            t0 = time.perf_counter()
            eager, graphed = (_graph_twin(kind, g, tmp, cg) for cg in (False, True))
            if eager.step_graphs.enabled or not graphed.step_graphs.enabled:
                raise AssertionError(f"{tag} the twins' graphs are not off and on")
            # the preprocessing's index_add_ sums with atomics on the card
            # (GAT-5's label smoothening): the graphed twin takes the eager
            # twin's feature table, in place
            n_feat = int((graphed.feat_tab != eager.feat_tab).sum())
            graphed.feat_tab.copy_(eager.feat_tab)
            _detail(f"{tag} feature tables of the twins' preprocessing differ in "
                    f"{n_feat} entries; the graphed twin takes the eager twin's")
            # the same epoch on both: losses, predictions, state, launches
            (p_e, l_e), (p_g, l_g) = _graph_epoch(eager), _graph_epoch(graphed)
            sg = graphed.step_graphs
            nbs = {m: -(-len(graphed.entity_set[m]) // graphed.batch_size)
                   for m in (TRAIN, VALID)}
            cached = ("cached",)
            want_replays = {("train", TRAIN, graphed.batch_size, cached): nbs[TRAIN] - 1,
                            ("eval", VALID, False, graphed.batch_size, cached):
                            nbs[VALID] - 1}
            got_replays = {k: sg.replays[k] for k in want_replays}
            if got_replays != want_replays or l_e != l_g:
                raise AssertionError(f"{tag} replays {got_replays}, want "
                                     f"{want_replays}; launches eager {l_e}, "
                                     f"graphed {l_g}")
            # serving at every size: the warm-up, the capture, replays
            sizes = GAT_SIZES if kind == "gat" else SERVE_SIZES
            rng = np.random.default_rng(3)
            test_ids = np.asarray(eager.entity_set[TEST])
            reqs = {s: [rng.choice(test_ids, s, replace=False)
                        for _ in range(GRAPH_REQS)] for s in sizes}
            for tr in (eager, graphed):
                tr.prepare_serving(TEST)
            exact, errs = _twin_check(tag, p_e, p_g, eager, graphed, True,
                                      _twin_serving(eager, graphed, reqs, tag))

            # timed in turns: TRAIN windows, their profiles, requests
            b = graphed.batch_size
            arrays = {id(tr): tr._epoch_arrays(TRAIN) for tr in (eager, graphed)}

            def window(tr, k):
                nb, roots, rows, labels, w = arrays[id(tr)]
                lo = (k * GRAPH_WINDOW) % (nb - GRAPH_WINDOW + 1)
                sl = slice(lo * b, (lo + GRAPH_WINDOW) * b)
                tr._run_batches(TRAIN, True, GRAPH_WINDOW, roots[sl], rows[sl],
                                labels[sl], w[sl], EpochRNG.from_seed(k, tr.device))

            timing = _twin_timing(tag, "step", eager, graphed, window, GRAPH_ROUNDS,
                                  GRAPH_WINDOW, reqs)
            print(f"{tag} graphed = eager "
                  + ("bit for bit" if exact else
                     "within " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
                  + f" (TRAIN+VALID {nbs[TRAIN]}+{nbs[VALID]} steps, state, serving "
                  f"{len(sizes)} sizes); replays {sum(sg.replays.values())}; {timing}; "
                  f"capture {sg.capture_s:.2f}s, pool {sg.pool_bytes / 2**20:.0f} MiB; "
                  f"part {time.perf_counter() - t0:.1f}s")
            _detail(f"{tag} graphs: {sg.summary()}; launches over the epoch {l_g}")
            del eager, graphed
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t_phase


# --------------------------------------------------------------------------
# [sampled graphs]: the compiled sampled step, and the BFS kernel
# --------------------------------------------------------------------------
SAMPLED_BUDGET_S = 150          # the phase aims at 90 s
SAMPLED_WINDOW = 8              # steps of a timed window
SAMPLED_ROUNDS = 2              # rounds of eager, graphed, graphed, eager windows
SAMPLED_REQS = 6                # timed requests of each size and twin, in turns
BFS_SIZES = (24, 37, 208, 210, 408, 907)     # 37, 210, 907: N % 4 != 0
BFS_WIDE = (100, 64)            # B, N of the case whose B * S passes the SM count
BFS_RULE_SIZES = (208, 408, 907)  # N of the timed sides of the cluster rule
# what the [sampled graphs] parts add up: their seconds, and the BFS
# kernel's launches over the graphed twins' passes (its main paths)
_SAMPLED = {"seconds": 0.0, "bfs_launches": 0}


def _bfs_cases(n, gen):
    """[6, n, n] f32 blocks on the card, a self edge on every valid node:
    a chain (n - 1 levels from node 0), two components, a block whose last
    quarter is padding (masked, its rows empty), a random sparse block, a
    block whose frontier rows cancel (node 0's row reaches 1 and 2; at
    the next level row 1 holds +1 and row 2 -1 on the columns 3 .. n/2,
    and -3 beside row 2's +1 on column n - 1: a sum of 0 or less where an
    entry is > 0), a dense block; the mask; starts [6, 2] (the padded
    block's second on padding, the random block's second beyond N)."""
    import torch
    adj = torch.zeros(6, n, n, device="cuda")
    i = torch.arange(n - 1, device="cuda")
    adj[0, i, i + 1] = 1.0
    adj[0, i + 1, i] = 1.0
    h = n // 2
    adj[1, :h, :h] = (torch.rand(h, h, generator=gen, device="cuda") < 3.0 / n).float()
    adj[1, h:, h:] = (torch.rand(n - h, n - h, generator=gen, device="cuda")
                      < 3.0 / n).float()
    adj[2] = (torch.rand(n, n, generator=gen, device="cuda") < 3.0 / n).float()
    adj[3] = (torch.rand(n, n, generator=gen, device="cuda") < 2.0 / n).float()
    adj[4] = (torch.rand(n, n, generator=gen, device="cuda") < 2.0 / n).float()
    if n >= 8:
        adj[4, 0] = 0.0
        adj[4, 0, 1:3] = 1.0
        adj[4, 1, 3:] = 1.0
        adj[4, 2, 3:h + 1] = -1.0
        adj[4, 1, n - 1], adj[4, 2, n - 1] = -3.0, 1.0
    adj[5] = (torch.rand(n, n, generator=gen, device="cuda") < 0.5).float()
    mask = torch.ones(6, n, dtype=torch.bool, device="cuda")
    mask[2, n - n // 4:] = False
    adj[2, n - n // 4:] = 0.0
    eye = torch.eye(n, device="cuda").bool()
    adj = torch.where(eye[None] & mask[:, :, None], 1.0, adj)
    starts = torch.tensor([[0, n - 1], [1, h + 1], [2, n - 1], [3, n], [0, n // 3],
                           [n // 2, 1]], device="cuda")
    return adj, starts, mask


def _sms():
    """The card's streaming multiprocessors."""
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def _bfs_sides(adj, starts, mask, want, what):
    """The BFS kernel at ``launch_dims``' cluster size and at the other
    side of its rule (one CTA where it takes a cluster, else the largest
    cluster that fits the SMs), each equal to ``want`` bit for bit:
    {cluster: ms}, ``launch_dims``' first; the launches not counted."""
    import torch
    from shadow_gnn_torch.ops import bfs
    b, n = adj.shape[:2]
    s = starts.shape[1]
    chosen = bfs.launch_dims(b, n, s, _sms()).cluster
    other = 1 if chosen > 1 else next(
        (c for c in bfs.CLUSTERS if b * s * c <= _sms()), 1)
    count = bfs.bfs_hops_multi.launches
    times = {}
    for c in dict.fromkeys((chosen, other)):
        def forced(b_, n_, s_, sms, c=c):
            return bfs.cluster_dims(b_, n_, s_, c)
        with _Swap((bfs, "launch_dims", forced)):
            if not torch.equal(bfs.bfs_hops_multi(adj, starts, mask), want):
                raise AssertionError(f"{what} the BFS kernel at cluster {c} differs "
                                     "from the plain version")
            times[c] = _time_ms(lambda: bfs.bfs_hops_multi(adj, starts, mask))
    bfs.bfs_hops_multi.launches = count
    return times


def _bfs_check(adj, starts, mask, what):
    """The BFS kernel against its plain version on one case, bit for bit
    (its detail to the log).  Returns the largest |kernel - plain|."""
    import torch
    from shadow_gnn_torch.ops import bfs
    got = bfs.bfs_hops_multi(adj, starts, mask)
    want = bfs.bfs_hops_plain(adj, starts, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"[bfs] {what}: the kernel differs from the plain version "
                             f"in {int((got != want).sum())} entries")
    b, n = adj.shape[:2]
    _detail(f"[bfs] {what}: kernel = plain bit for bit (cluster "
            f"{bfs.launch_dims(b, n, starts.shape[1], _sms()).cluster}, levels "
            f"{[int(x) for x in want.amax((1, 2))][:8]}, {int((want >= 0).sum())} "
            "nodes reached)")
    return int((got - want).abs().max())


def phase_bfs():
    """The BFS kernel (``csrc/bfs_hops.cu``) against its plain version,
    bit for bit: chain, disconnected, padded, random, cancelling and dense
    blocks at N of ``BFS_SIZES`` (N % 4 != 0 among them), S = 1 and 2;
    random blocks whose B * S passes the SM count (``BFS_WIDE``); a chain
    of ``MAX_N`` nodes; an N above it is refused by name.  Returns the
    largest |kernel - plain|."""
    import torch
    from shadow_gnn_torch.ops import bfs
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases, err = 0, 0
    for n in BFS_SIZES:
        adj, starts, mask = _bfs_cases(n, gen)
        for s in (1, 2):
            err = max(err, _bfs_check(adj, starts[:, :s].contiguous(), mask,
                                      f"N={n} S={s}"))
            cases += 1
    b, n = BFS_WIDE
    adj = (torch.rand(b, n, n, generator=gen, device="cuda") < 3.0 / n).float()
    mask = torch.ones(b, n, dtype=torch.bool, device="cuda")
    adj = torch.where(torch.eye(n, device="cuda").bool()[None], 1.0, adj)
    starts = torch.randint(0, n, (b, 2), generator=gen, device="cuda")
    err = max(err, _bfs_check(adj, starts, mask, f"B={b} N={n} S=2"))
    del adj
    # the limit: a chain of MAX_N nodes, MAX_N - 1 levels from node 0
    n = bfs.MAX_N
    adj = torch.zeros(1, n, n, device="cuda")
    i = torch.arange(n - 1, device="cuda")
    adj[0, i, i + 1] = adj[0, i + 1, i] = 1.0
    adj[0, i, i] = 1.0
    chain = (adj, torch.zeros(1, 1, dtype=torch.int64, device="cuda"),
             torch.ones(1, n, dtype=torch.bool, device="cuda"))
    err = max(err, _bfs_check(*chain, f"chain N={n}"))
    if not torch.equal(bfs.bfs_hops_multi(*chain)[0, 0],
                       torch.arange(n, device="cuda")):
        raise AssertionError(f"[bfs] the chain of {n} nodes has other levels")
    del adj, chain
    torch.cuda.empty_cache()
    # the two sides of launch_dims' cluster rule (CLUSTER_MIN_N): blocks
    # like the cold step's PPR subgraphs (a hub on every node, random
    # edges), B = 8, S = 1, N below and above the rule
    sides, won = [], {True: [], False: []}
    for n in BFS_RULE_SIZES:
        adj = (torch.rand(8, n, n, generator=gen, device="cuda") < 4.0 / n).float()
        adj[:, 0] = adj[:, :, 0] = 1.0
        adj = torch.where(torch.eye(n, device="cuda").bool()[None], 1.0, adj)
        starts = torch.zeros(8, 1, dtype=torch.int64, device="cuda")
        mask = torch.ones(8, n, dtype=torch.bool, device="cuda")
        t = _bfs_sides(adj, starts, mask, bfs.bfs_hops_plain(adj, starts, mask),
                       f"[bfs] N={n}")
        sides.append(f"N={n} " + " vs ".join(f"C{c} {ms:.4f}" for c, ms in t.items()))
        won[min(t, key=t.get) == next(iter(t))].append(n)
    _detail(f"[bfs] launch_dims' cluster vs the other side (hub blocks, B=8, S=1, "
            f"ms): {'; '.join(sides)}")
    big = bfs.MAX_N + 1
    try:
        bfs.check_shapes(torch.empty(1, big, big, device="meta"),
                         torch.zeros(1, 1, dtype=torch.int64, device="meta"),
                         torch.ones(1, big, dtype=torch.bool, device="meta"))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"[bfs] N={big} was not refused")
    _detail(f"[bfs] refused: {refused}")
    print(f"[bfs] kernel = plain bit for bit: {cases} cases (N {BFS_SIZES}, S 1/2), "
          f"B*S {2 * BFS_WIDE[0]}, a chain of N={bfs.MAX_N}; N={big} refused; cluster "
          f"rule faster at N {won[True]}, slower {won[False]}; "
          f"{time.perf_counter() - t0:.1f}s")
    return err


def _time_eager_ms(fn, iters=10, warmup=2):
    """Device time of one call of ``fn`` that reads the device on the host
    (it cannot be captured): CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    for _ in range(iters):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / iters


def _bfs_time(batch, s, tag):
    """The BFS kernel and its plain version on ``batch``'s blocks from its
    first ``s`` targets: (kernel ms, plain ms, bound ms, bytes); the
    bound counts the rows of the nodes the sources reach (each read once),
    the mask, the starts and the output.  The kernel at the other side of
    ``launch_dims``' cluster rule goes to the log beside its own."""
    import torch
    from shadow_gnn_torch.ops import bfs
    adj = batch.adj.contiguous()
    starts = batch.targets[:, :s].contiguous()
    mask = batch.node_mask
    dist = bfs.bfs_hops_multi(adj, starts, mask)
    if not torch.equal(dist, bfs.bfs_hops_plain(adj, starts, mask)):
        raise AssertionError(f"{tag} the BFS kernel differs from the plain version")
    b, n, _ = adj.shape
    rows = int((dist >= 0).any(1).sum())
    byts = rows * n * 4 + b * n + b * s * 8 + b * s * n * 8
    bound_ms = byts / HBM_BYTES_PER_S * 1e3
    sides = _bfs_sides(adj, starts, mask, dist, tag)
    cluster, ms = next(iter(sides.items()))
    plain_ms = _time_eager_ms(lambda: bfs.bfs_hops_plain(adj, starts, mask))
    _detail(f"{tag} bfs_hops B={b} N={n} S={s}: kernel {ms:.4f} ms (cluster "
            f"{cluster}; by cluster " + ", ".join(
                f"{c}: {t:.4f}" for c, t in sides.items()) + f"), plain "
            f"{plain_ms:.4f} ms (a host read a level, {int(dist.max())} levels), "
            f"bound {bound_ms:.5f} ms (bytes: {rows} reached rows of {n * 4} B, "
            f"{byts / 1e6:.3f} MB)")
    return ms, plain_ms, bound_ms, byts


def phase_bfs_cache(tr, tag):
    """The cached TRAIN subgraphs of ``tr`` (hop annotation through the BFS
    kernel) against a cache built through the plain BFS on the same
    tables: byte-equal.  Then the kernel timed on one cold TRAIN batch
    (the main path's shape).  Returns the kernels-line row (its launches
    filled in at the end)."""
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.ops import bfs
    from shadow_gnn_torch.sampling import cache as cache_mod
    from shadow_gnn_torch.sampling import induction
    from shadow_gnn_torch.sampling.samplers import sample_subgraphs
    cfg, graph, tabs = (tr.branches[0]["cfg"][TRAIN], tr.graph[TRAIN],
                        tr.tables[TRAIN][0])
    ent = tr.entity_set[TRAIN]
    roots = torch.as_tensor(ent[:, None], device="cuda")
    rows = torch.arange(len(ent), device="cuda")[:, None]
    with _Swap((induction, "bfs_hops_multi", bfs.bfs_hops_plain)), torch.no_grad():
        plain = cache_mod.build_cache(
            lambda r, rw: sample_subgraphs(cfg, graph, r, rw, tabs), roots, rows, cfg)
    kern = tr.caches[TRAIN][0]
    for f in ("nodes", "adj_bits", "targets", "hop", "ppr", "drnl"):
        if not torch.equal(getattr(kern, f), getattr(plain, f)):
            raise AssertionError(f"{tag} the TRAIN cache through the BFS kernel "
                                 f"differs from the plain BFS's in {f}")
    b = tr.batch_size
    with torch.no_grad():
        batch = sample_subgraphs(cfg, graph, roots[:b], rows[:b], tabs)
    ms, plain_ms, bound_ms, _ = _bfs_time(batch, 1, tag)
    print(f"{tag} TRAIN cache via the BFS kernel = via the plain BFS ({len(ent)} "
          f"subgraphs); bfs_hops {ms:.4f} ms, plain {plain_ms:.4f}, bound "
          f"{bound_ms:.5f}")
    return {"name": "bfs_hops", "route": "cuda",
            "source": "shadow_gnn_torch/csrc/bfs_hops.cu",
            "replaces": "shadow_gnn_tpu/sampling/induction.py:422",
            "launches": None, "max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def _sampled_twin(kind, g, src, cuda_graphs):
    """A 1-epoch trainer of the [sampled graphs] path ``kind`` ("power",
    "ensemble", "gat" or "link") that takes ``src``'s PPR tables and
    induction plans (the same graph, seed and splits: no second push),
    its first-epoch profile off."""
    from shadow_gnn_torch import TRAIN
    if kind == "power":
        tr = _flagship_trainer(g, epochs=1, tag="[sampled power]",
                               cuda_graphs=cuda_graphs)
    elif kind == "ensemble":
        tr = _ensemble_trainer(g, epochs=1, cuda_graphs=cuda_graphs)
    elif kind == "gat":
        tr = _gat_trainer(g, epochs=1, cuda_graphs=cuda_graphs)
    else:
        tr = _link_trainer(g, epochs=1, cuda_graphs=cuda_graphs)
    tr.tables = dict(src.tables)
    for mine, theirs in zip(tr.branches, src.branches):
        mine["cfg"] = dict(theirs["cfg"])
    tr.profiler.enabled = False
    if kind == "power":
        tr.disable_cache(TRAIN)             # its cold steps
    return tr


def _sampled_passes(tr, kind):
    """The path's passes on ``tr`` (``inference`` of VALID and TEST for
    "gat", else TRAIN epoch 0 and its VALID pass), each ``_run_batches``
    recorded as (what, losses, predictions, overflow); the launch counts
    over them, the BFS kernel's set to 0 just before and read just after."""
    import torch
    from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
    from shadow_gnn_torch.ops import bfs
    from shadow_gnn_torch.train import graphs
    passes, run_batches = [], tr._run_batches

    def recorded(mode, train, *args):
        out = run_batches(mode, train, *args)
        passes.append((f"{MODE2STR[mode]} {'train' if train else 'eval'}", out[0],
                       out[1], int(out[2])))
        return out

    counters = graphs.launch_counters()
    bfs.bfs_hops_multi.launches = 0
    before = graphs.counter_values(counters)
    tr._run_batches = recorded
    try:
        if kind == "gat":
            tr.inference((VALID, TEST))
        else:
            tr.run_epoch(0, TRAIN)
            tr.run_epoch(0, VALID)
        torch.cuda.synchronize()
    finally:
        del tr._run_batches
    after = graphs.counter_values(counters)
    return passes, {name: a - b for name, a, b in
                    zip(_counter_names(counters), after, before) if a != b}


def _twin_profile(tag, eager, graphed):
    """The first-epoch profile of TRAIN (``Trainer._profile_epoch``) on both
    twins: the graphed one's stats (hop composition, nodes, edges,
    subgraphs) equal to the eager one's, every batch but its key's first
    replayed.  Returns the replays."""
    import numpy as np
    from shadow_gnn_torch import TRAIN
    stats = []
    for tr in (eager, graphed):
        p = tr.profiler
        p.clear_metrics()
        tr._ensure_tables(TRAIN)
        tr._ensure_caches(TRAIN)
        tr._profile_epoch(TRAIN)
        stats.append((np.asarray(p.hop_comp), p.num_nodes, p.num_edges, p.num_subg))
        p.clear_metrics()
        p.enabled = False
    key = ("profile", TRAIN, graphed.batch_size, graphed._cache_sig(TRAIN))
    nb = -(-len(graphed.entity_set[TRAIN]) // graphed.batch_size)
    same = all(np.array_equal(a, b) for a, b in zip(*stats))
    if not same or graphed.step_graphs.replays[key] != nb - 1:
        raise AssertionError(f"{tag} profile: stats eager {stats[0]}, graphed "
                             f"{stats[1]}; {key} replayed "
                             f"{graphed.step_graphs.replays[key]} of {nb}")
    _detail(f"{tag} first-epoch profile graphed = eager: avg nodes "
            f"{stats[1][1][0] / stats[1][3][0]:.1f} over {stats[1][3][0]} subgraphs")
    return nb - 1


STAGES = ("sample", "membership", "annotate", "bfs", "forward", "backward",
          "optimizer", "other")


def _stage_split(tag, eager, graphed, window, n):
    """The device time of a sampled TRAIN step by stage (D2.2): one window
    of ``n`` eager-twin steps under torch.profiler, read by the program's
    spans (``shadow_gnn_torch/spans.py``): ``sgnn.stage.sample``
    (``_static_batches``: PPR gather, khop, ``ppr_st``, the feature
    gather) and within it ``membership``, ``annotate`` and ``bfs``,
    ``forward`` (model and loss), ``backward``, ``optimizer`` (clip +
    Adam), inside ``sgnn.step``; each kernel's duration goes to the
    innermost span open on the host when the runtime call that launched
    it ran (matched by CUPTI's correlation id; a kernel launched outside
    the stages, or with no such call, is "other").  Then one window of
    the graphed twin, its device time by kernel name.  The detail goes to
    the log; returns the summary text (ms a step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    labels = {f"sgnn.stage.{s}" for s in STAGES} | {"sgnn.step"}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        window(eager, SAMPLED_ROUNDS + 1)
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name.rsplit(".", 1)[-1])
                   for e in events if e.device_type == DeviceType.CPU and e.name in labels)
    # a device event and the CUDA API call that launched it
    # (cudaLaunchKernel; cuLaunchKernel from cuBLAS) share an id, CUPTI's
    # correlation; the call's host time places it in a range
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    kern = [e for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    by_stage = dict.fromkeys(STAGES, 0.0)
    for e in kern:
        t, inner = launched.get(e.id), None
        for lo, hi, name in spans if t is not None else ():
            if lo <= t <= hi and (inner is None or lo >= inner[0]):
                inner = (lo, hi, name)
        stage = "other" if inner is None or inner[2] == "step" else inner[2]
        by_stage[stage] += e.time_range.elapsed_us() / 1e3 / n
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / n
    if busy == 0.0:
        return "by stage not measured (the profiler saw no device time)"
    with profile(activities=acts) as prof:
        window(graphed, SAMPLED_ROUNDS + 1)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    g_busy = sum(by_name.values())
    g_bfs = sum(v for k, v in by_name.items() if "bfs_kernel" in k)
    _detail(f"{tag} eager twin, device ms a step by stage ({n} steps, kernels by "
            f"launching range; all kernels {busy:.4f}; ranges "
            f"{sorted(set(name for _, _, name in spans))}): " + ", ".join(
                f"{k} {v:.4f}" for k, v in by_stage.items()))
    _detail(f"{tag} graphed twin, device ms a step {g_busy:.4f}, by kernel: " + "; ".join(
        f"{v:.4f} {k[:60]}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]))
    induce = by_stage["membership"] + by_stage["annotate"] + by_stage["bfs"]
    return (f"device ms a step by stage (eager twin): sample {by_stage['sample']:.3f}, "
            f"induce {induce:.3f} (bfs {by_stage['bfs']:.3f}), fwd "
            f"{by_stage['forward']:.3f}, bwd {by_stage['backward']:.3f}, opt "
            f"{by_stage['optimizer']:.3f} of {busy:.3f} ({100 * induce / busy:.0f}% "
            f"induce); graphed {g_busy:.3f}, bfs_kernel {g_bfs:.4f}")


def phase_sampled(kind, g, src):
    """[sampled graphs] for one path: an eager twin (``cuda_graphs=False``)
    and a graphed trainer from one seed, both on ``src``'s PPR tables:
    their passes (``_sampled_passes``: per-step losses and predictions,
    the overflow, every kernel's launches), the final parameters and Adam
    state, and for the ensemble requests of 1/8/64/128 ids (its PPR branch
    gathered, its khop branch sampled), held graphed against eager bit for
    bit (``GRAPH_TOLS`` where not, printed); every sampled step key but its
    first call must replay.  Then in turns: the step (eager, graphed,
    graphed, eager windows of ``SAMPLED_WINDOW`` steps, host clock to a
    synchronise; eval steps for "gat"), its device-busy share and host
    CUDA calls (torch.profiler), and the ensemble's request p50; a TRAIN
    step's device time by stage (``_stage_split``).  Adds its seconds
    and the graphed twin's BFS launches to ``_SAMPLED``."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.train.pipeline import EpochRNG
    tag = f"[sampled {kind}]"
    t0 = time.perf_counter()
    eager, graphed = (_sampled_twin(kind, g, src, cg) for cg in (False, True))
    if eager.step_graphs.enabled or not graphed.step_graphs.enabled:
        raise AssertionError(f"{tag} the twins' graphs are not off and on")
    if kind == "gat":
        # GAT-5's label smoothening sums with atomics: one feature table
        graphed.feat_tab.copy_(eager.feat_tab)
    # the first-epoch profile's graph (sampled TRAIN branches)
    prof = _twin_profile(tag, eager, graphed) if kind in ("power", "ensemble") else 0
    (p_e, l_e), (p_g, l_g) = (_sampled_passes(tr, kind) for tr in (eager, graphed))
    _SAMPLED["bfs_launches"] += l_g.get("bfs_hops_multi.launches", 0)
    ovf = {w: (oe, og) for (w, _, _, oe), (_, _, _, og) in zip(p_e, p_g)}
    if len(p_e) != 2 or len(p_g) != 2 or any(a != b for a, b in ovf.values()):
        raise AssertionError(f"{tag} passes {len(p_e)} / {len(p_g)}, overflow eager "
                             f"/ graphed {ovf}")
    if l_e != l_g:
        raise AssertionError(f"{tag} launches eager {l_e}, graphed {l_g}")
    sg, b = graphed.step_graphs, graphed.batch_size
    want_replays = {}
    for m, (_, losses, _, _) in zip((VALID, TEST) if kind == "gat" else (TRAIN,), p_g):
        sig = graphed._cache_sig(m)
        key = ("eval", m, False, b, sig) if kind == "gat" else ("train", m, b, sig)
        if "sampled" not in sig:
            raise AssertionError(f"{tag} {key} has no sampled branch")
        want_replays[key] = len(losses) - 1
    got_replays = {k: sg.replays[k] for k in want_replays}
    if got_replays != want_replays:
        raise AssertionError(f"{tag} replays {got_replays}, want {want_replays}")
    reqs = {}
    if kind == "ensemble":
        rng = np.random.default_rng(3)
        test_ids = np.asarray(eager.entity_set[TEST])
        reqs = {s: [rng.choice(test_ids, s, replace=False)
                    for _ in range(SAMPLED_REQS)] for s in GAT_SIZES}
    exact, errs = _twin_check(tag, [p[:3] for p in p_e], [p[:3] for p in p_g], eager,
                              graphed, kind != "gat",
                              _twin_serving(eager, graphed, reqs, tag))

    # timed in turns: windows of steps, their profiles, requests
    mode, train = (VALID, False) if kind == "gat" else (TRAIN, True)
    arrays = {id(tr): tr._epoch_arrays(mode) for tr in (eager, graphed)}
    win = min(SAMPLED_WINDOW, arrays[id(eager)][0])

    def window(tr, k):
        nb, roots, rows, labels, w = arrays[id(tr)]
        lo = (k * win) % (nb - win + 1)
        sl = slice(lo * b, (lo + win) * b)
        tr._run_batches(mode, train, win, roots[sl], rows[sl], labels[sl], w[sl],
                        EpochRNG.from_seed(k, tr.device))

    timing = _twin_timing(tag, "eval step" if kind == "gat" else "TRAIN step", eager,
                          graphed, window, SAMPLED_ROUNDS, win, reqs)
    stages = None if kind == "gat" else _stage_split(tag, eager, graphed, window, win)
    part = time.perf_counter() - t0
    _SAMPLED["seconds"] += part
    _detail(f"{tag} passes {' + '.join(f'{w} {len(l)}' for w, l, _, _ in p_g)} "
            f"steps{', state' if kind != 'gat' else ''}"
            f"{f', serving {len(reqs)} sizes' if reqs else ''}; launches equal, "
            f"bfs {l_g.get('bfs_hops_multi.launches', 0)}; replays "
            f"{sum(sg.replays.values())}; part {part:.1f}s")
    print(f"{tag} graphed = eager "
          + ("bit for bit" if exact else
             "within " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
          + f", overflow {sum(o for _, o in ovf.values())}"
          + (f", profile = eager ({prof} replays)" if prof else "") + f"; {timing}")
    if stages:
        print(f"{tag} {stages}")
    _detail(f"{tag} graphs: {sg.summary()}; launches over the passes {l_g}")
    del eager, graphed
    torch.cuda.empty_cache()


PARALLEL_RUNS = (("nccl", 1, "cuda"), ("gloo", 4, "cuda:0"))
PARALLEL_WINDOW = 8             # steps of each timed window
PARALLEL_ROUNDS = 2             # rounds of eager, graphed, graphed, eager windows
PARALLEL_TIMEOUT_S = 300        # a rank's group fails a collective waiting longer
PARALLEL_HANG_S = 150           # a rank's partition that takes longer dumps its stacks
PARALLEL_BUDGET_S = 360         # the phase aims at 240 s
# kind -> (partitions of the NCCL run, of the gloo run), the kernels that
# every rank of a run must launch, the splits' cuts
PARALLEL_MODELS = {
    "flagship": (("dp", "feat"), ("dp",), ("packed_spmm", "packed_spmm_t"),
                 (TRAIN_NODES, VALID_NODES, TEST_NODES)),
    "gat": (("edge",), ("edge",), ("gat_attention", "gat_attention_bwd"),
            (GAT_TRAIN, GAT_VALID, GAT_TEST)),
}


def _parallel_cfg(kind):
    """The model's config at dropout 0 and dropedge 0, 1 epoch."""
    cfg = _flagship_cfg(1) if kind == "flagship" else _gat_cfg(1)
    cfg["hyperparameter"].update(dropout=0.0, dropedge=0.0)
    return cfg


def _parallel_trainer(spec, g, device, partition="none", cuda_graphs=True):
    """A trainer of ``spec`` on ``g`` (its PPR cache in ``spec["dir"]``),
    the splits cut, the profile off.  A rank's trainer takes the
    reference's feature table (``spec["feat"]``): the label smoothening
    sums with the atomic ``index_add_`` on the card, so a table
    preprocessed again differs in its last bits, and a kinked activation
    downstream turns that into gradients 1e-3 of their max apart."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer
    tr = Trainer(spec["name"], spec["dir"], _own_splits(g), parse_config(spec["cfg"]),
                 seed=0, device=device, packed_adj=spec["packed"],
                 use_device_ppr=False, partition=partition, cuda_graphs=cuda_graphs)
    _cut_splits(tr, zip((TRAIN, VALID, TEST), spec["cuts"]))
    tr.profiler.enabled = False
    if partition == "none":
        np.save(spec["feat"], tr.feat_np)
    else:
        tr.feat_np = np.load(spec["feat"])
        tr.feat_tab = torch.as_tensor(tr.feat_np).to(tr.device, tr.feat_tab.dtype)
    return tr


def _kernel_fns(names):
    from shadow_gnn_torch.ops import gat, packed
    return [getattr(packed, n, None) or getattr(gat, n) for n in names]


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_profile(dev, fn, n):
    """Run ``fn()`` (``n`` steps) under torch.profiler: (device-busy ms,
    host CUDA calls, the NCCL kernels' share of the busy time) a step;
    Nones where the profiler sees no device time (or on the CPU)."""
    if dev.type != "cuda":
        fn()
        return None, None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    kern = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    api = [e for e in prof.events()
           if e.device_type == DeviceType.CPU and e.name.startswith("cuda")]
    us = sum(e.time_range.elapsed_us() for e in kern)
    nccl = sum(e.time_range.elapsed_us() for e in kern if "nccl" in e.name.lower())
    return (us / 1e3 / n or None), len(api) / n, (nccl / us if us else None)


def _collective_shares(dev, fn):
    """Run ``fn()`` under torch.profiler (host events): the host seconds
    of its ``sgnn.collective.<op>`` and ``.wait`` spans and of
    ``sgnn.collective.stage`` (gloo's staging through host memory), each
    over the wall time.  A gloo call returns when it is done, so its span
    holds its time; an NCCL call's span holds its enqueue (its kernels'
    share is ``_rank_profile``'s)."""
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    secs = {"call": 0.0, "stage": 0.0}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sgnn.collective."):
            secs["stage" if e.name() == "sgnn.collective.stage" else "call"] += (
                e.duration_ns() * 1e-9)
    return secs["call"] / wall, secs["stage"] / wall


def _partition_passes(tr, fn):
    """Run ``fn()`` with every ``_run_partition`` pass of ``tr`` recorded:
    (its result, the passes as (what, losses, predictions, overflow))."""
    from shadow_gnn_torch import MODE2STR
    passes, run = [], tr._run_partition

    def recorded(mode, train, *args):
        out = run(mode, train, *args)
        passes.append((MODE2STR[mode].upper(), out[0], out[1], int(out[2])))
        return out

    tr._run_partition = recorded
    try:
        return fn(), passes
    finally:
        del tr._run_partition


def _parallel_rank(spec):
    """One rank of a [parallel] run, for each partition of ``spec``: a
    graphed trainer and, where its graphs are on (an NCCL group), an
    eager twin (``cuda_graphs=False``), both from the start weights (the
    PPR tables from the parent's cache).  Batch 0's induced blocks
    (``edge``); the TRAIN epoch on each, the first step apart (its loss,
    gradients and parameters from the eager twin: the rank's path of PR
    12), with step ms, every kernel's launches and the collectives' calls
    and bytes; the twins held bit for bit (``_twin_check``: per-step
    losses and predictions, parameters, Adam state; the overflow, the
    launches and the collectives' counts equal) and every TRAIN step of
    the graphed one but its key's first replayed.  Then in turns
    ``PARALLEL_ROUNDS`` rounds of eager, graphed, graphed, eager windows,
    the eager twin's collectives' share read from their spans over one
    more (both run it), and
    one window each under torch.profiler (device-busy share, host CUDA
    calls, NCCL's share); the replicas' checksum and one VALID epoch on
    each twin, held again, every VALID step but the first replayed.
    Writes ``<tag>.<partition>.rank<r>.npz`` / ``.json`` and logs to
    ``<tag>.rank<r>.log`` in ``spec["dir"]``."""
    import pickle
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN, VALID
    from shadow_gnn_torch.parallel import multihost as mh
    from shadow_gnn_torch.train import graphs
    r, dev = mh.rank(), mh.device()
    base = os.path.join(spec["dir"], spec["tag"])
    sys.stdout = open(f"{base}.rank{r}.log", "w", buffering=1)
    print(f"rank {r} of {mh.world_size()} ({mh.backend()}) on {dev}")
    with open(spec["graph"], "rb") as f:
        g = pickle.load(f)
    fns = _kernel_fns(spec["kernels"])
    counters = graphs.launch_counters()
    start = torch.load(spec["state"], map_location=dev)
    for part in spec["partitions"]:
        # a partition that hangs dumps every thread's stack into the log,
        # and the rank exits (the parent's spawn then fails)
        faulthandler.dump_traceback_later(PARALLEL_HANG_S, exit=True, file=sys.stdout)
        t_run = time.perf_counter()
        tag = f"[parallel {spec['tag']} {part} rank {r}]"
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        graphed = _parallel_trainer(spec, g, dev, part)
        twins = graphed.step_graphs.enabled
        trs = ([_parallel_trainer(spec, g, dev, part, cuda_graphs=False)]
               if twins else []) + [graphed]
        eager = trs[0]
        arrays = {}
        for tr in trs:
            tr.model.load_state_dict(start)
            tr._ensure_tables(TRAIN)
            tr._ensure_caches(TRAIN)
            nb, *ea = tr._epoch_arrays(TRAIN)
            arrays[id(tr)] = (*ea, int(tr.rng_np.integers(1 << 31)))
        b, sl = eager.batch_size, mh.process_slice(eager.batch_size)
        out, npz = {"partition": part, "twins": twins, "plan": graphed._graph_plan()}, {}
        print(f"{part}: {out['plan']}")
        if part == "edge":
            roots, rows = arrays[id(eager)][:2]
            with torch.no_grad():
                batches, _ = eager._partition_step(TRAIN, True).sample_all(
                    torch.as_tensor(roots[sl].astype(np.int64), device=dev),
                    torch.as_tensor(rows[sl].astype(np.int64), device=dev),
                    torch.Generator(device=dev).manual_seed(0))
            for k in ("nodes", "adj", "hop"):
                npz[f"block_{k}"] = getattr(batches[0], k).cpu().numpy()

        def run(tr, lo, n, seed=None):
            roots, rows, labels, w, s = arrays[id(tr)]
            cut = slice(lo * b, (lo + n) * b)
            return tr._run_partition(TRAIN, True, n, roots[cut], rows[cut], labels[cut],
                                     w[cut], s if seed is None else seed)

        epoch = {}
        for tr in trs:
            for fn in fns:
                fn.launches = 0
            before = graphs.counter_values(counters)
            first = run(tr, 0, 1)
            if tr is eager:
                out["loss0"] = float(first[0][0])
                if r == 0:
                    for k, p in tr.model.named_parameters():
                        npz[f"grad/{k}"] = p.grad.cpu().numpy().copy()
                    for k, v in tr.model.state_dict().items():
                        npz[f"param1/{k}"] = v.cpu().numpy().copy()
            _sync(dev)
            t0 = time.perf_counter()
            rest = run(tr, 1, nb - 1)
            _sync(dev)
            after = graphs.counter_values(counters)
            epoch[id(tr)] = {
                "step_ms": (time.perf_counter() - t0) * 1e3 / max(nb - 1, 1),
                "launches": [fn.launches for fn in fns],
                "pass": ("TRAIN", np.concatenate([first[0], rest[0]]),
                         np.concatenate([first[1], rest[1]])),
                "ovf": int(first[2] + rest[2]),
                "counts": {name: a - c for name, a, c in
                           zip(_counter_names(counters), after, before) if a != c}}
        e_ep = epoch[id(eager)]
        out.update(step_ms=e_ep["step_ms"], launches=e_ep["launches"],
                   collective_calls=e_ep["counts"].get("collectives.calls", 0) / nb,
                   collective_mb=e_ep["counts"].get("collectives.bytes", 0) / nb / 2**20)
        per = sl.stop - sl.start
        if twins:
            g_ep = epoch[id(graphed)]
            if (e_ep["ovf"], e_ep["counts"]) != (g_ep["ovf"], g_ep["counts"]):
                raise AssertionError(f"{tag} overflow and counts eager {e_ep['ovf']} "
                                     f"{e_ep['counts']}, graphed {g_ep['ovf']} "
                                     f"{g_ep['counts']}")
            key = ("ptrain", TRAIN, per, graphed._partition_step(TRAIN, True).sig())
            if graphed.step_graphs.replays[key] != nb - 1:
                raise AssertionError(f"{tag} {key} replayed "
                                     f"{graphed.step_graphs.replays[key]} of {nb} steps")
            out["exact"], errs = _twin_check(tag, [e_ep["pass"]], [g_ep["pass"]], eager,
                                             graphed, True, [])
            out["errs"] = errs
            out.update(graphed_ms=g_ep["step_ms"], replays=nb - 1, ovf=g_ep["ovf"],
                       train_steps=nb)
            print(f"{part}: epoch graphed = eager, {'bit for bit' if out['exact'] else errs}"
                  f"; counts {g_ep['counts']}")

        # timed in turns; the eager twin's collectives read from their
        # spans over a profiled window that both run
        window = min(PARALLEL_WINDOW, nb)

        def win(tr, k):
            run(tr, (k * window) % (nb - window + 1), window, seed=k)

        times = {id(tr): [] for tr in trs}
        for k in range(PARALLEL_ROUNDS):
            for tr in ((eager, graphed, graphed, eager) if twins else (eager,)):
                _sync(dev)
                t0 = time.perf_counter()
                win(tr, k)
                _sync(dev)
                times[id(tr)].append((time.perf_counter() - t0) * 1e3 / window)
        out["collective_share"], out["stage_share"] = _collective_shares(
            dev, lambda: win(eager, PARALLEL_ROUNDS))
        if twins:
            win(graphed, PARALLEL_ROUNDS)
        out["window_ms"] = [_median(times[id(tr)]) for tr in trs]
        out["windows"] = [[round(x, 3) for x in times[id(tr)]] for tr in trs]
        print(f"{part}: windows {out['windows']}")
        out["checksum"] = graphed.param_checksum().cpu().tolist()
        if r == 0:
            torch.save(graphed.model.state_dict(), f"{base}.{part}.final.pt")
        valid = [_partition_passes(tr, lambda tr=tr: tr.run_epoch(0, VALID))
                 for tr in trs]
        out["valid"] = [valid[-1][0]["loss"], valid[-1][0]["accuracy"]]
        if twins:
            (s_e, p_e), (s_g, p_g) = valid
            nb_v = len(p_g[0][1])
            key = ("peval", VALID, per, graphed._partition_step(VALID, False).sig())
            if (graphed.step_graphs.replays[key] != nb_v - 1
                    or p_e[0][3] != p_g[0][3] or s_e["accuracy"] != s_g["accuracy"]):
                raise AssertionError(f"{tag} VALID {key} replayed "
                                     f"{graphed.step_graphs.replays[key]} of {nb_v} "
                                     f"steps; overflow {p_e[0][3]} / {p_g[0][3]}; "
                                     f"accuracy {s_e['accuracy']} / {s_g['accuracy']}")
            exact, errs = _twin_check(f"{tag} VALID", [p[:3] for p in p_e],
                                      [p[:3] for p in p_g], eager, graphed, True, [])
            out["exact"] = out["exact"] and exact
            out["errs"].update(errs)
            out["replays"] += nb_v - 1
            out["valid_steps"] = nb_v
            out["graphs"] = graphed.step_graphs.summary()
            print(f"{part}: VALID graphed = eager; {out['graphs']}")
        # last: one window of each twin under torch.profiler
        prof = [_rank_profile(dev, lambda tr=tr: win(tr, PARALLEL_ROUNDS + 1), window)
                for tr in trs]
        out["busy_share"] = [p[0] / ms if p[0] else None
                             for p, ms in zip(prof, out["window_ms"])]
        out["host_calls"] = [p[1] for p in prof]
        out["nccl_share"] = [p[2] for p in prof]
        out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                           if dev.type == "cuda" else None)
        out["dispatches"] = graphed.partition_train_dispatches
        out["run_s"] = time.perf_counter() - t_run
        print(f"{part}: {json.dumps(out)}")
        np.savez(f"{base}.{part}.rank{r}.npz", **npz)
        with open(f"{base}.{part}.rank{r}.json", "w") as f:
            json.dump(out, f)
        del tr, trs, eager, graphed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        faulthandler.cancel_dump_traceback_later()


def _parallel_reference(spec, g, device, worlds):
    """The single-card path on the same graph, weights and first batch,
    as a dict: the trainer, its rng_np state where the ranks' VALID
    epoch starts, batch 0's induced blocks (sampled uncached), the
    whole batch's first-step ``loss`` / ``grads`` / ``params``, and for
    each world size W > 1 of ``worlds`` the same step over the ranks'
    column slices in turn (W forwards at the ranks' shapes, each part
    divided by the whole batch's weight sum, the gradients accumulated,
    then one clip and Adam step).  The whole batch's products take other
    GEMM shapes than a rank's B / W rows, so its kinked activations may
    cross 0 where a rank's do not; the slices' step has the ranks'
    shapes.  Writes the start weights."""
    import copy
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN, VALID
    from shadow_gnn_torch.sampling.samplers import sample_subgraphs
    from shadow_gnn_torch.train.pipeline import (CLIP_NORM, EpochRNG,
                                                 clip_grad_global_norm_,
                                                 make_optimizer, weighted_loss_parts)
    tr = _parallel_trainer(spec, g, device)
    start = copy.deepcopy(tr.model.state_dict())
    torch.save(start, spec["state"])
    start_np = {k: v.cpu().numpy().astype(np.float64) for k, v in start.items()}
    for m in (TRAIN, VALID):
        tr._ensure_tables(m)             # the push, cached for the ranks
    tr._ensure_caches(TRAIN)
    nb, roots, rows, labels, w = tr._epoch_arrays(TRAIN)
    b, dev = tr.batch_size, tr.device
    roots_d = torch.as_tensor(roots[:b].astype(np.int64), device=dev)
    rows_d = torch.as_tensor(rows[:b].astype(np.int64), device=dev)
    with torch.no_grad():
        blk = sample_subgraphs(tr.branches[0]["cfg"][TRAIN], tr.graph[TRAIN],
                               roots_d, rows_d, tr.tables[TRAIN][0])
    ref = {"tr": tr, "start": start_np,
           "blocks": {k: getattr(blk, k).cpu().numpy() for k in ("nodes", "adj", "hop")}}
    seed = int(tr.rng_np.integers(1 << 31))
    ref["rng_state"] = copy.deepcopy(tr.rng_np.bit_generator.state)

    def snapshot(loss):
        return (loss, {k: p.grad.cpu().numpy().copy()
                       for k, p in tr.model.named_parameters()},
                {k: v.cpu().numpy().copy() for k, v in tr.model.state_dict().items()})
    losses, _, _ = tr._run_batches(TRAIN, True, 1, roots[:b], rows[:b], labels[:b],
                                   w[:b], EpochRNG.from_seed(seed, dev))
    ref[1] = snapshot(float(losses[0]))
    lab_d = torch.as_tensor(labels[:b].astype(np.int64), device=dev)
    w_d = torch.as_tensor(w[:b], device=dev)
    for world in sorted(set(worlds) - {1}):
        tr.model.load_state_dict(start)
        tr.optimizer = make_optimizer(tr.model.parameters(),
                                      float(tr.params_train["lr"]))
        tr.model.train()
        den = torch.clamp(w_d.sum(), min=1.0)
        loss, per = 0.0, b // world
        for r in range(world):
            sl = slice(r * per, (r + 1) * per)
            with torch.no_grad():
                batches, feats = tr._sample_branch_batches(TRAIN, roots_d[sl],
                                                           rows_d[sl])
            logits, _ = tr.model(batches, feats, None, 0, True)
            part = weighted_loss_parts(tr.model_cfg, logits, lab_d[sl], w_d[sl])[0] / den
            part.backward()
            loss += float(part.detach())
        clip_grad_global_norm_(tr.model.parameters(), CLIP_NORM)
        tr.optimizer.step()
        tr.model.eval()
        ref[world] = snapshot(loss)
    return ref


def _parallel_check(tag, ranks, ref, world):
    """Hold one partitioned run against the single-card reference: the
    loss against the whole batch's (1e-5 relative); the gradients and
    the updated parameters against the same step over the ranks' slices
    (``_parallel_reference``; 1e-5 of their max), the whole batch's
    gradient distance printed; the ranks' checksums equal; ``edge``:
    each rank's induced blocks equal the single card's.  Returns (loss
    rel, gradient and parameter errors of their max, the weights left
    free, the whole batch's gradient distance)."""
    import numpy as np
    loss_ref = ref[1][0]
    _, grads_ref, params_ref = ref[world]
    blocks = ref["blocks"]
    arrays0 = {k[4:]: v for k, v in ranks[0].items() if k.startswith("arr/")}
    part = ranks[0]["partition"]
    rel = max(abs(o["loss0"] - loss_ref) / abs(loss_ref) for o in ranks)
    if rel > 1e-5:
        raise AssertionError(f"{tag} {part}: first-step loss {rel:.2e} relative "
                             "from the single card's")
    def g_dist(want):
        return max(float(np.abs(arrays0[f"grad/{k}"] - v).max())
                   / max(float(np.abs(v).max()), 1e-30) for k, v in want.items())
    g_err, g_whole = g_dist(grads_ref), g_dist(ref[1][1])
    if g_err > 1e-5:
        raise AssertionError(f"{tag} {part}: first-step gradients {g_err:.2e} of "
                             "their max from the single card's")
    # Adam's first step moves a weight by lr * g / (|g| + eps): +-lr by the
    # sign of g where |g| >> eps.  A gradient within the check's 1e-5 of
    # its max may take either sign, and within 1e-5 of 0 (1000 eps) the
    # step still bends, moving by up to lr * eps * |dg| / (|g| + eps)^2:
    # there the rank's step is held to Adam of the rank's own gradient
    # (the rank applied the update it computed); every weight to that,
    # and every other one to the single card's, within 1e-5 of its
    # parameter's max
    lr, eps = float(ref["tr"].params_train["lr"]), 1e-8
    p_err, a_err, free, name = 0.0, 0.0, 0, ""
    for k, v in params_ref.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        got, gk = arrays0[f"param1/{k}"], grads_ref.get(k)
        d = np.abs(got - v)
        if gk is not None:
            g_rank = arrays0[f"grad/{k}"].astype(np.float64)
            adam = ref["start"][k] - lr * g_rank / (np.abs(g_rank) + eps)
            a_err = max(a_err, float(np.abs(got - adam).max()) / scale)
            bent = np.abs(gk) <= max(1e-5 * float(np.abs(gk).max()), 1e3 * eps)
            free += int((bent & (d > 1e-5 * scale)).sum())
            d = np.where(bent, 0.0, d)
        if float(d.max()) / scale > p_err:
            p_err, name = float(d.max()) / scale, k
    if max(p_err, a_err) > 1e-5:
        raise AssertionError(f"{tag} {part}: updated parameters {p_err:.2e} of "
                             f"their max from the single card's ({name}), "
                             f"{a_err:.2e} from Adam of the rank's gradients")
    if any(o["checksum"] != ranks[0]["checksum"] for o in ranks):
        raise AssertionError(f"{tag} {part}: the ranks' parameters differ")
    if part == "edge":
        b = blocks["nodes"].shape[0] // world
        for r, a in enumerate(ranks):
            for k, want in blocks.items():
                if not np.array_equal(a[f"arr/block_{k}"], want[r * b:(r + 1) * b]):
                    raise AssertionError(f"{tag} edge: rank {r}'s induced {k} differ "
                                         "from the single card's")
    return rel, g_err, p_err, free, g_whole


def phase_parallel(g, kind, runs=PARALLEL_RUNS, spec_update=None):
    """[parallel] for one model: the single-card reference in this process,
    then each run of ``runs`` spawned through ``parallel/launch.py`` (the
    CLI's entry; the kernels already built): every partition's first
    TRAIN step, its launches, the replicas, one VALID epoch, and on an
    NCCL run the graphed trainer against its eager twin
    (``_parallel_rank``); an NCCL rank that does not capture fails the
    phase.  One summary line a run and partition on standard output, the
    ranks' logs in the full log."""
    import glob
    import pickle
    import shutil
    import tempfile
    import numpy as np
    import torch
    from shadow_gnn_torch import VALID
    from shadow_gnn_torch.parallel import launch
    t_phase = time.perf_counter()
    nccl_parts, gloo_parts, kernels, cuts = PARALLEL_MODELS[kind]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        spec = dict(name=f"{kind}_synth", dir=tmp, cfg=_parallel_cfg(kind), cuts=cuts,
                    packed=kind == "flagship", kernels=kernels,
                    state=os.path.join(tmp, "state.pt"),
                    graph=os.path.join(tmp, "graph.pkl"),
                    feat=os.path.join(tmp, "feat.npy"))
        spec.update(spec_update or {})
        with open(spec["graph"], "wb") as f:
            pickle.dump(g, f, protocol=pickle.HIGHEST_PROTOCOL)
        dev = torch.device(runs[0][2].split(":")[0])
        ref = _parallel_reference(spec, g, dev, [world for _, world, _ in runs])
        tr_ref = ref["tr"]
        for backend, world, device in runs:
            parts = nccl_parts if backend == "nccl" or world == 1 else gloo_parts
            tag = f"{kind}.{backend}{world}"
            t0 = time.perf_counter()
            try:
                launch.spawn(_parallel_rank, world, device,
                             (dict(spec, tag=tag, partitions=parts),), backend=backend,
                             timeout_s=PARALLEL_TIMEOUT_S)
            finally:
                # the ranks' logs, also those of a failed run
                for path in sorted(glob.glob(os.path.join(tmp, f"{tag}.rank*.log"))):
                    with open(path) as f:
                        _detail(f"[parallel] {os.path.basename(path)}:\n"
                                f"{f.read().rstrip()}")
            spawn_s = time.perf_counter() - t0
            for part in parts:
                ranks = []
                for r in range(world):
                    with open(os.path.join(tmp, f"{tag}.{part}.rank{r}.json")) as f:
                        o = json.load(f)
                    for k, v in np.load(os.path.join(
                            tmp, f"{tag}.{part}.rank{r}.npz")).items():
                        o[f"arr/{k}"] = v
                    ranks.append(o)
                rel, g_err, p_err, free, g_whole = _parallel_check(
                    f"[parallel {tag}]", ranks, ref, world)
                low = [o["launches"] for o in ranks if min(o["launches"], default=0) <= 0]
                if part != "feat" and spec["kernels"] and low:
                    raise AssertionError(f"[parallel {tag}] {part}: a rank launched "
                                         f"no {spec['kernels']} kernel: {low}")
                tr_ref.model.load_state_dict(torch.load(
                    os.path.join(tmp, f"{tag}.{part}.final.pt"), map_location=dev))
                tr_ref.rng_np.bit_generator.state = ref["rng_state"]
                want = tr_ref.run_epoch(0, VALID)
                accs = {o["valid"][1] for o in ranks}
                if accs != {want["accuracy"]}:
                    raise AssertionError(f"[parallel {tag}] {part}: VALID accuracy "
                                         f"{accs} against the single card's "
                                         f"{want['accuracy']}")
                per = [f"{o['step_ms']:.2f}" for o in ranks]
                mem = [f"{o['peak_gib']:.2f}" if o["peak_gib"] is not None else "n/a"
                       for o in ranks]
                o = ranks[0]

                def pair(key, fmt):
                    return " / ".join("n/m" if v is None else format(v, fmt)
                                      for v in o[key])
                _detail(f"[parallel] {kind} {part} {backend}{world}: "
                        f"{free} bent-step weights held to Adam; first-step "
                        f"gradients {g_whole:.1e} of max from the whole batch's; "
                        f"launches a rank {[x['launches'] for x in ranks]}; "
                        f"collectives {o['collective_calls']:.0f} calls, "
                        f"{o['collective_mb']:.2f} MiB a step, their share of an "
                        f"eager window {o['collective_share']:.3f} (gloo staging "
                        f"{o['stage_share']:.3f}); epoch step ms a rank {'/'.join(per)}; "
                        f"windows (eager[, graphed]) {o['windows']}; peak GiB "
                        f"{'/'.join(mem)}{' (both twins)' if o['twins'] else ''}; "
                        f"plan: {o['plan']}; {o.get('graphs', '')}; spawn {spawn_s:.1f}s")
                head = (f"[parallel] {kind} {part} {backend}{world}: step 1 loss "
                        f"{rel:.1e} rel, grads {g_err:.1e}, params {p_err:.1e}; "
                        f"{'/'.join(spec['kernels'])} {o['launches']} (rank 0); "
                        f"VALID acc = 1 card; ")
                if backend == "nccl" and not all(x["twins"] for x in ranks):
                    raise AssertionError(f"[parallel {tag}] {part}: an NCCL rank "
                                         f"runs eagerly: {o['plan']}")
                if o["twins"]:
                    same = all(x["exact"] for x in ranks)
                    print(head + "graphed = eager " + (
                        "bit for bit" if same else "within GRAPH_TOLS "
                        + str(max((x["errs"] for x in ranks), key=str)))
                        + f" ({o['train_steps']}+{o['valid_steps']} steps, "
                        f"{o['replays']} replays); "
                        f"step ms e/g {pair('window_ms', '.2f')}, busy "
                        f"{pair('busy_share', '.2f')}, host calls "
                        f"{pair('host_calls', '.0f')}, nccl {pair('nccl_share', '.3f')}")
                else:
                    if "every step runs eagerly" not in o["plan"]:
                        raise AssertionError(f"[parallel {tag}] {part}: the plan of "
                                             f"an ungraphed rank: {o['plan']}")
                    print(head + f"eager ({backend}: every step); step ms "
                          f"{'/'.join(f'{x:.2f}' for x in (y['window_ms'][0] for y in ranks))}"
                          f", collectives {o['collective_share']:.3f} (staging "
                          f"{o['stage_share']:.3f}), busy {pair('busy_share', '.2f')}")
        del tr_ref, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"[parallel] {kind} phase {wall:.1f}s")
    return wall


# ---------------------------------------------------------------------------
# [ring]: the ring SpMM and the C&S propagation as CUDA graphs; torchrun
# ---------------------------------------------------------------------------

RING_BUDGET_S = 90              # the phase aims at 60 s
RING_ROUNDS = 2                 # rounds of eager, graphed, graphed, eager calls
RING_CALLS = 3                  # calls of a key held: warm-up, capture + replay, replay
RING_SMOOTH = ("sym-2-concat", "ppr--concat-0.8")
RING_SMOOTH_TOL = 1e-5          # of max |single card|: the smoothening ring
RING_TORCHRUN_S = 300           # the torchrun epoch's time limit
RING_QUIET_S = 120              # the NCCL rank's wait for the runs beside it


def _ring_turns(eager, graphed, n):
    """Device ms a step of ``eager()`` and ``graphed()`` (``n`` steps a
    call), CUDA events around each call, in turns: ``RING_ROUNDS`` rounds
    of eager, graphed, graphed, eager; the medians."""
    import torch
    times = ([], [])
    for _ in range(RING_ROUNDS):
        for i in (0, 1, 1, 0):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            (eager, graphed)[i]()
            ev[1].record()
            torch.cuda.synchronize()
            times[i].append(ev[0].elapsed_time(ev[1]) / n)
    return [_median(t) for t in times]


def _nccl_overlap(dev, fn):
    """The share of the NCCL kernels' device time during which another
    kernel runs, over ``fn()`` under torch.profiler: the ring's transfer
    on NCCL's stream overlapping ``index_add_`` (None without NCCL
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    kern = [(e.time_range.start, e.time_range.end, "nccl" in e.name.lower())
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    others = sorted((a, b) for a, b, nccl in kern if not nccl)
    total = hit = 0
    for a, b, nccl in kern:
        if not nccl:
            continue
        total += b - a
        for c, d in others:
            if c >= b:
                break
            hit += max(0, min(b, d) - max(a, c))
    return hit / total if total else None


def _twin(eager_fn, graphed_fn, calls=RING_CALLS):
    """The largest |graphed - eager| over ``calls`` calls of the graphed
    function (its warm-up, capture and replays), each against the eager
    result; 0.0 is bit for bit."""
    want = eager_fn().clone()
    return max(float((graphed_fn() - want).abs().max()) for _ in range(calls))


def _twin_word(errs, cause):
    worst = max(errs)
    return "bit for bit" if worst == 0 else f"within TOL_CS ({worst:.1e}: {cause})"


def _ring_single(graph, y0, tag):
    """(a) the single-card C&S (``postproc/cns.py:Propagation``), graphed
    against its eager twin at both ``norm_sym`` values: ``RING_CALLS``
    calls of the graphed one, each held against the eager result, every
    call after the first replaying; then ms a step in turns, the host
    CUDA calls, device-busy share a step (torch.profiler), the pool's MiB
    and the peak memory.  Returns ({use_norm: the eager result}, the
    summary)."""
    import torch
    from shadow_gnn_torch.postproc import cns
    dev = torch.device("cuda")
    op, deg = cns.mean_operator(graph.indptr_full, graph.indices_full, dev)
    y0_d = torch.as_tensor(y0, device=dev)
    want, ms, calls, errs, pool, peak = {}, [], [], [], 0, 0.0
    for use_norm in (False, True):
        eager, graphed = cns.Propagation(op, deg, cuda_graphs=False), cns.Propagation(op, deg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        errs.append(_twin(lambda: eager(y0_d, use_norm=use_norm),
                          lambda: graphed(y0_d, use_norm=use_norm)))
        peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
        replays = sum(graphed.graphs.replays.values())
        if replays != RING_CALLS - 1 or not errs[-1] <= TOL_CS:
            raise AssertionError(f"{tag} single-card C&S norm_sym {use_norm}: "
                                 f"{replays} replays, graphed - eager {errs[-1]}")
        ms += _ring_turns(lambda: eager(y0_d, use_norm=use_norm),
                          lambda: graphed(y0_d, use_norm=use_norm), cns.N_PROP)
        for f in (eager, graphed):
            busy, host, _ = _rank_profile(dev, lambda f=f: f(y0_d, use_norm=use_norm),
                                          cns.N_PROP)
            calls.append((busy, host))
        pool = max(pool, graphed.graphs.pool_bytes)
        want[use_norm] = eager(y0_d, use_norm=use_norm).cpu().numpy()
        _detail(f"{tag} single-card C&S norm_sym {use_norm}: {graphed.graphs.summary()}"
                f"; graphed - eager {errs[-1]:.3e}; ms a step eager / graphed "
                f"{ms[-2]:.4f} / {ms[-1]:.4f}; busy ms, host CUDA calls a step "
                f"{calls[-2]} / {calls[-1]}")
        graphed.graphs.release()
    line = (f"{tag} 1 card C&S: graphed = eager {_twin_word(errs, 'cuSPARSE')}, "
            f"{RING_CALLS - 1} replays/key; "
            f"ms/step e/g off {ms[0]:.4f}/{ms[1]:.4f}, on {ms[2]:.4f}/{ms[3]:.4f}; "
            f"host calls/step {calls[0][1]:.0f}/{calls[1][1]:.2f}; pool "
            f"{pool / 2**20:.0f} MiB, peak {peak:.2f} GiB")
    return want, line


def _wait_files(paths, timeout_s):
    """Wait until every file of ``paths`` exists (the parent's marks that
    a run beside this one has ended); returns the seconds waited."""
    t0 = time.perf_counter()
    while not all(os.path.exists(p) for p in paths):
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"waited {timeout_s} s for {paths}")
        time.sleep(0.2)
    return time.perf_counter() - t0


def _ring_rank(spec):
    """One rank of a [ring] run.  With ``spec["cli"]`` (an argv): the
    CLI's C&S at ``n_shards`` = the world, first.  With
    ``spec["smooth"]``: ``smooth_signal_full`` through the ring against
    the single card (``RING_SMOOTH``).  Then, once the files
    ``spec["quiet"]`` exist (the runs beside the untimed parts have
    ended): the ring C&S
    (``parallel/edgepart.py:make_outcome_correlation``) on the products
    graph at both ``norm_sym`` values against the single-card result
    within ``TOL_CS``; where its graphs are on (an NCCL group) a graphed
    operator against its eager twin (``RING_CALLS`` calls a key, every
    call after the first replaying), ms a step in turns, the host CUDA
    calls, busy share and NCCL share a step and the NCCL kernels'
    overlap with the others (torch.profiler); with ``spec["smooth"]`` a
    product of ``make_ring_spmm`` graphed against eager and timed; the
    pools and the peak memory.  Writes ``<tag>.rank<r>.json`` and logs
    to ``<tag>.rank<r>.log``."""
    import numpy as np
    import torch
    from shadow_gnn_torch import main as tmain
    from shadow_gnn_torch.parallel import edgepart as ep
    from shadow_gnn_torch.parallel import multihost as mh
    from shadow_gnn_torch.postproc import cns
    from shadow_gnn_torch.train import preproc
    r, w, dev = mh.rank(), mh.world_size(), mh.device()
    base = os.path.join(spec["dir"], spec["tag"])
    sys.stdout = open(f"{base}.rank{r}.log", "w", buffering=1)
    faulthandler.dump_traceback_later(PARALLEL_HANG_S, exit=True, file=sys.stdout)
    out = {"plan": f"rank {r} of {w} ({mh.backend()}) on {dev}"}
    print(out["plan"])
    torch.cuda.reset_peak_memory_stats(dev)
    if spec.get("cli"):
        made, accs = [], []
        make, smooth = ep.make_outcome_correlation, cns.correct_smooth

        def recording_make(*a, **k):
            made.append(make(*a, **k))
            return made[-1]

        def recording_smooth(*a, **k):
            accs.append(smooth(*a, **k))
            return accs[-1]
        ep.make_outcome_correlation, cns.correct_smooth = recording_make, recording_smooth
        try:
            t0 = time.perf_counter()
            rc = tmain.main(spec["cli"])
        finally:
            ep.make_outcome_correlation, cns.correct_smooth = make, smooth
        out["cli"] = dict(rc=rc, seconds=time.perf_counter() - t0,
                          acc_cs={int(m): v for m, v in accs[0][1].items()},
                          replays=sum(made[0].graphs.replays.values()),
                          graphs=made[0].graphs.summary())
        print(f"CLI: {out['cli']}")
        del made, accs
    if spec["smooth"]:
        fz = np.load(spec["smooth_graph"])
        indptr, indices, feat = fz["indptr"], fz["indices"], fz["feat"]
        out["smooth"] = {}
        for cfg in RING_SMOOTH:
            tn, order, red, args = preproc.decode_smoothen_config(cfg)
            t0 = time.perf_counter()
            want, k1 = preproc.smooth_signal_full(indptr, indices, feat, tn, order, red,
                                                  args, dev)
            t1 = time.perf_counter()
            got, k2 = preproc.smooth_signal_full(indptr, indices, feat, tn, order, red,
                                                 args, dev, n_shards=w)
            err = float(np.abs(got - want).max() / np.abs(want).max())
            out["smooth"][cfg] = dict(err=err, steps=[k1, k2], single_s=t1 - t0,
                                      ring_s=time.perf_counter() - t1)
            print(f"smoothening {cfg}: {out['smooth'][cfg]}")
        del want, got
    gz = np.load(spec["cs_graph"])
    t0 = time.perf_counter()
    graphed = ep.make_outcome_correlation(gz["indptr"], gz["indices"], w, dev)
    twins = graphed.graphs.enabled
    eager = (ep.make_outcome_correlation(gz["indptr"], gz["indices"], w, dev,
                                         cuda_graphs=False) if twins else graphed)
    out.update(build_s=time.perf_counter() - t0, twins=twins,
               graphs_plan=graphed.graphs.summary(), cs={})
    if spec.get("quiet"):
        out["waited_s"] = _wait_files(spec["quiet"], RING_QUIET_S)
    y0 = torch.as_tensor(gz["y0"], device=dev)
    for use_norm in (False, True):
        t0 = time.perf_counter()
        ref = eager(y0, use_norm=use_norm).cpu().numpy()
        o = {"call_s": time.perf_counter() - t0,
             "single": float(np.abs(ref - gz[f"want{int(use_norm)}"]).max())}
        if twins:
            before = sum(graphed.graphs.replays.values())
            o["twin"] = _twin(lambda: eager(y0, use_norm=use_norm),
                              lambda: graphed(y0, use_norm=use_norm))
            o["replays"] = sum(graphed.graphs.replays.values()) - before
            o["ms"] = _ring_turns(lambda: eager(y0, use_norm=use_norm),
                                  lambda: graphed(y0, use_norm=use_norm), cns.N_PROP)
            o["prof"] = [_rank_profile(dev, lambda f=f: f(y0, use_norm=use_norm),
                                       cns.N_PROP) for f in (eager, graphed)]
            if w > 1:
                o["overlap"] = _nccl_overlap(dev, lambda: graphed(y0, use_norm=use_norm))
        print(f"C&S norm_sym {use_norm}: {o}")
        out["cs"][int(use_norm)] = o
    out["pool_mib"] = graphed.graphs.pool_bytes / 2**20
    out["graphs"] = graphed.graphs.summary()
    del graphed, eager, y0
    if spec["smooth"]:
        src, dst, val = preproc._norm_edges(indptr, indices, "sym")
        n = indptr.size - 1
        prod_g = ep.make_ring_spmm(src.astype(np.int64), dst.astype(np.int64), val, n,
                                   w, dev)
        prod_e = ep.make_ring_spmm(src.astype(np.int64), dst.astype(np.int64), val, n,
                                   w, dev, cuda_graphs=False)
        x = torch.as_tensor(feat, device=dev)
        p = {"twin": _twin(lambda: prod_e(x), lambda: prod_g(x)) if twins else None,
             "replays": sum(prod_g.graphs.replays.values())}
        if twins:
            p["ms"] = _ring_turns(lambda: prod_e(x), lambda: prod_g(x), 1)
            p["pool_mib"] = prod_g.graphs.pool_bytes / 2**20
        out["product"] = p
        print(f"product: {p}")
        del prod_g, prod_e, x
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    faulthandler.cancel_dump_traceback_later()
    with open(f"{base}.rank{r}.json", "w") as f:
        json.dump(out, f)


def _ring_spawn(spec, world, device, backend):
    """``_ring_rank`` on ``world`` ranks (``parallel/launch.py``); the
    ranks' logs go to the full log, also when the spawn fails.  Returns
    the ranks' results and the spawn's seconds."""
    import glob
    from shadow_gnn_torch.parallel import launch
    t0 = time.perf_counter()
    try:
        launch.spawn(_ring_rank, world, device, (spec,), backend=backend,
                     timeout_s=PARALLEL_TIMEOUT_S)
    finally:
        for path in sorted(glob.glob(os.path.join(spec["dir"],
                                                  f"{spec['tag']}.rank*.log"))):
            with open(path) as f:
                _detail(f"[ring] {os.path.basename(path)}:\n{f.read().rstrip()}")
    ranks = []
    for r in range(world):
        with open(os.path.join(spec["dir"], f"{spec['tag']}.rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


def _ring_check(tag, ranks, nccl):
    """Every rank's ring C&S within ``TOL_CS`` of the single card; on an
    NCCL run graphed = eager within ``TOL_CS``, ``RING_CALLS - 1`` replays
    a key; a gloo run eager and saying so.  Returns the largest errors
    (single card, twin)."""
    single = max(o["cs"][k]["single"] for o in ranks for k in o["cs"])
    if not single <= TOL_CS:
        raise AssertionError(f"{tag} the ring C&S and the single card differ by {single}")
    if not nccl:
        if any(o["twins"] or "every step runs eagerly" not in o["graphs_plan"]
               for o in ranks):
            raise AssertionError(f"{tag} a gloo rank's ring is graphed: "
                                 f"{ranks[0]['graphs_plan']}")
        return single, None
    if not all(o["twins"] for o in ranks):
        raise AssertionError(f"{tag} an NCCL rank's ring runs eagerly: "
                             f"{ranks[0]['graphs_plan']}")
    twin = max(o["cs"][k]["twin"] for o in ranks for k in o["cs"])
    replays = {o["cs"][k]["replays"] for o in ranks for k in o["cs"]}
    if not twin <= TOL_CS or replays != {RING_CALLS - 1}:
        raise AssertionError(f"{tag} the graphed ring C&S: graphed - eager {twin}, "
                             f"replays {replays}")
    if "smooth" in ranks[0]:
        p = [o["product"] for o in ranks]
        worst = max(o["smooth"][c]["err"] for o in ranks for c in RING_SMOOTH)
        steps = {tuple(o["smooth"][c]["steps"]) for o in ranks for c in RING_SMOOTH}
        if (not worst <= RING_SMOOTH_TOL or any(a != b for a, b in steps)
                or not max(x["twin"] for x in p) <= TOL_CS
                or {x["replays"] for x in p} != {RING_CALLS - 1}):
            raise AssertionError(f"{tag} the smoothening ring: {worst} of max from "
                                 f"the single card, steps {steps}, products {p}")
    return single, twin


def _ring_cli_check(tag, cli, want, lab, node_set, err):
    """The CLI's C&S accuracies (``RING_CALLS`` matrices) against the
    single card's on every split: a row may change its argmax only where
    its two largest entries of the single card's matrix lie within
    ``2 * err`` (the largest ring - single card difference); the count
    of such rows bounds the difference.  Returns the largest bound."""
    import numpy as np
    if cli["rc"] != 0 or cli["replays"] != RING_CALLS - 1:
        raise AssertionError(f"{tag} the CLI's C&S: {cli}")
    top2 = np.sort(want, 1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= 2 * err
    bound = 0.0
    for m, accs in cli["acc_cs"].items():
        idx = node_set[int(m)]
        acc = float((want[idx].argmax(1) == lab[idx]).mean())
        slack = float(near[idx].mean())
        bound = max(bound, slack)
        if len(accs) != RING_CALLS or max(abs(a - acc) for a in accs) > slack:
            raise AssertionError(f"{tag} the CLI's C&S accuracy {accs} against the "
                                 f"single card's {acc} (slack {slack})")
    return bound


def _torchrun_start(flickr, tmp):
    """(e) ``python -m torch.distributed.run --nproc_per_node 1 -m
    shadow_gnn_torch.main ... --distributed --partition dp`` in the
    background: the flagship at its [parallel] config (dropout and
    dropedge 0, 1 epoch; as JSON, which needs no PyYAML) on the
    flickr-scale graph written in the shaDow format with its splits cut
    to the [parallel] cuts, device PPR.  Returns (process, port, log,
    start time)."""
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.data import save_shadow_format
    from shadow_gnn_torch.parallel import multihost as mh
    data = os.path.join(tmp, "flagship_data")
    cuts = zip((TRAIN, VALID, TEST), (TRAIN_NODES, VALID_NODES, TEST_NODES))
    save_shadow_format(data, "flickr_synth", indptr=flickr.indptr_full,
                       indices=flickr.indices_full, feat=flickr.feat_full,
                       label=flickr.label_full,
                       node_set={m: flickr.node_set[m][:k] for m, k in cuts})
    cfg = os.path.join(tmp, "flagship.json")
    with open(cfg, "w") as f:
        json.dump(_parallel_cfg("flagship"), f)
    port = mh.free_port()
    log = os.path.join(tmp, "torchrun.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
           "--master_addr", "127.0.0.1", "--master_port", str(port),
           "-m", "shadow_gnn_torch.main", "--configs", cfg, "--dataset", "flickr_synth",
           "--data_dir", data, "--log_dir", os.path.join(tmp, "log"), "--seed", "0",
           "--distributed", "--partition", "dp", "--packed_adj", "--no_log",
           "--device_ppr", "device"]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, port, log, time.perf_counter()


def _torchrun_finish(run, tag):
    """Wait for the torchrun epoch: exit code 0, rank 0 of 1 joined over
    NCCL at the launcher's address, its dp steps graphed, a final
    summary.  Returns (the epoch's summary, its seconds)."""
    proc, port, log, t0 = run
    try:
        rc = proc.wait(timeout=RING_TORCHRUN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        with open(log) as f:
            text = f.read()
        _detail(f"{tag} torchrun output:\n{text.rstrip()}")
    joined = f"rank 0 of 1 (nccl) on cuda:0, joined at 127.0.0.1:{port}"
    graphed = "partition dp over nccl: the TRAIN and eval steps replay CUDA graphs"
    final = [ln for ln in text.splitlines() if ln.startswith("FINAL SUMMARY")]
    if rc != 0 or joined not in text or graphed not in text or not final:
        raise AssertionError(f"{tag} torchrun: exit {rc}; joined {joined in text}, "
                             f"graphed {graphed in text}, final summary {bool(final)}")
    return final[0], time.perf_counter() - t0


def phase_ring(products, pred, flickr):
    """[ring] after [infer]'s GAT-5 C&S, on its prediction matrix, labels
    and products graph (every TRAIN label known): (a) the single-card
    C&S graphed against its eager twin (``_ring_single``), and the C&S
    at ``n_shards`` 1 in this process, which is in no group; (b) in one
    NCCL rank of world 1 (``parallel/launch.py``): the ring C&S graphed
    against eager and against the single card, the CLI's C&S
    (``main.main`` with ``--postproc_configs``, JSON, ``n_shards: 1``, on
    a run dir and dataset written here, three matrices) against the
    single card's accuracies; (c) there too, the smoothening ring on the
    flickr-scale graph (``RING_SMOOTH``) against the single card and a
    product graphed against eager; (d) gloo world 4 on cuda:0, the ring
    C&S eager by design, against the single card; (e) torchrun
    (``_torchrun_start``).  (d) and (e) run beside (b)'s untimed parts
    (the CLI, the smoothening): the NCCL rank times its calls once both
    have ended.  Three summary lines."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.data import save_shadow_format
    from shadow_gnn_torch.postproc import cns
    tag, t_phase = "[ring]", time.perf_counter()
    g = products
    y0 = cns.seed_matrix(pred, g.label_full, g.node_set[TRAIN])
    want, line_a = _ring_single(g, y0, tag)
    print(line_a)
    # n_shards 1 in this process, which is in no group: the collectives
    # answer locally
    local = float(np.abs(cns.general_outcome_correlation(
        g.indptr_full, g.indices_full, y0, n_shards=1, device="cuda")
        - want[False]).max())
    if not local <= TOL_CS:
        raise AssertionError(f"{tag} n_shards 1 outside a group: {local} from the "
                             "single card")
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ring_")
    torchrun = None
    try:
        spec = dict(dir=tmp, cs_graph=os.path.join(tmp, "cs.npz"),
                    smooth_graph=os.path.join(tmp, "smooth.npz"), smooth=True)
        np.savez(spec["cs_graph"], indptr=g.indptr_full, indices=g.indices_full, y0=y0,
                 want0=want[False], want1=want[True])
        np.savez(spec["smooth_graph"], indptr=flickr.indptr_full,
                 indices=flickr.indices_full, feat=flickr.feat_full)
        data, run = os.path.join(tmp, "data"), os.path.join(tmp, "run")
        save_shadow_format(data, "products_synth", indptr=g.indptr_full,
                           indices=g.indices_full, feat=g.feat_full, label=g.label_full,
                           node_set=g.node_set)
        os.makedirs(run)
        np.save(os.path.join(run, "pred_mat_gen.npy"), pred)
        with open(os.path.join(tmp, "cs.json"), "w") as f:
            json.dump({"method": "cs", "dir_pred_mat": [run] * RING_CALLS,
                       "hyperparameter": {"norm_sym": False, "alpha": 0.8,
                                          "n_shards": 1}}, f)
        spec["cli"] = ["--postproc_configs", os.path.join(tmp, "cs.json"), "--dataset",
                       "products_synth", "--data_dir", data, "--log_dir",
                       os.path.join(tmp, "log"), "--device", "cuda"]
        t_a = time.perf_counter() - t_phase
        # gloo world 4 and the torchrun epoch run beside the NCCL rank's
        # untimed parts; it times its calls once both have ended
        torchrun = _torchrun_start(flickr, tmp)
        side = {"gloo4": lambda: _ring_spawn(
                    dict(spec, tag="gloo4", smooth=False, cli=None), 4, "cuda:0",
                    "gloo"),
                "torchrun": lambda: _torchrun_finish(torchrun, tag)}
        done = {k: os.path.join(tmp, f"{k}.done") for k in side}
        results = {}

        def beside(name):
            try:
                results[name] = side[name]()
            except BaseException as e:      # re-raised in the phase's thread
                results[name] = e
            finally:
                open(done[name], "w").close()
        threads = [threading.Thread(target=beside, args=(k,)) for k in side]
        for t in threads:
            t.start()
        try:
            nccl1, s_nccl = _ring_spawn(dict(spec, tag="nccl1",
                                             quiet=list(done.values())),
                                        1, "cuda", "nccl")
        finally:
            for t in threads:
                t.join()
        for res in results.values():
            if isinstance(res, BaseException):
                raise res
        (gloo4, s_gloo), (final, wait_s) = results["gloo4"], results["torchrun"]
        single1, twin1 = _ring_check(f"{tag} nccl1", nccl1, True)
        bound = _ring_cli_check(f"{tag} nccl1", nccl1[0]["cli"], want[False],
                                g.label_full, g.node_set, single1)
        single4, _ = _ring_check(f"{tag} gloo4", gloo4, False)
    finally:
        if torchrun is not None and torchrun[0].poll() is None:
            torchrun[0].kill()
            torchrun[0].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    o = nccl1[0]
    cs = o["cs"]
    sm = o["smooth"]
    _detail(f"{tag} nccl1 rank 0: {json.dumps(o)}")
    _detail(f"{tag} gloo4: " + "; ".join(json.dumps(x["cs"]) for x in gloo4))
    _detail(f"{tag} torchrun: {final}; parts: single card and files {t_a:.1f}s, "
            f"NCCL 1 spawn {s_nccl:.1f}s (its wait for the runs beside it "
            f"{nccl1[0]['waited_s']:.1f}s), beside it gloo 4 spawn {s_gloo:.1f}s and "
            f"torchrun {wait_s:.1f}s")
    print(f"{tag} NCCL 1 (no group {local:.0e}): ring C&S - 1 card {single1:.1e}, "
          f"graphed = eager "
          f"{_twin_word([twin1], 'atomic index_add_')}, {RING_CALLS - 1} replays/key; "
          f"ms/step e/g off "
          f"{cs['0']['ms'][0]:.4f}/{cs['0']['ms'][1]:.4f}, on {cs['1']['ms'][0]:.4f}/"
          f"{cs['1']['ms'][1]:.4f}; host calls/step {cs['0']['prof'][0][1]:.0f}/"
          f"{cs['0']['prof'][1][1]:.2f}; pool {o['pool_mib']:.0f} MiB, peak "
          f"{o['peak_gib']:.2f} GiB; CLI acc = 1 card (slack {bound:.1e}); smooth "
          + "/".join(f"{sm[c]['err']:.0e}" for c in RING_SMOOTH)
          + f" of max, product ms e/g {o['product']['ms'][0]:.3f}/"
          f"{o['product']['ms'][1]:.3f}")
    wall = time.perf_counter() - t_phase
    g_ms = [x["cs"][k]["call_s"] * 1e3 / cns.N_PROP for x in gloo4[:1] for k in ("0", "1")]
    print(f"{tag} gloo 4 eager: - 1 card {single4:.1e}, ms/step off/on "
          f"{g_ms[0]:.1f}/{g_ms[1]:.1f}; torchrun dp epoch joined the launcher's "
          f"group, graphed; phase {wall:.1f}s (aim 60, budget {RING_BUDGET_S}); "
          f"{_card()}")
    if wall > RING_BUDGET_S:
        raise AssertionError(f"{tag} took {wall:.1f}s, over its {RING_BUDGET_S} s budget")
    return wall


def phase_ring_nccl4(products, flickr):
    """[ring] at NCCL world 4 (``--parallel-nccl4``, one rank a card): the
    ring C&S on the products graph (a prediction matrix from seed 0)
    and the smoothening ring on the flickr-scale graph, graphed against
    eager and against the single card (cuda:0, in this process), the
    ring shifts captured; the NCCL kernels' overlap with ``index_add_``
    from torch.profiler."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.postproc import cns
    tag, t0 = "[ring nccl4]", time.perf_counter()
    g = products
    rng = np.random.default_rng(0)
    pred = rng.random((g.num_nodes, int(g.label_full.max()) + 1)).astype(np.float32)
    y0 = cns.seed_matrix(pred / pred.sum(1, keepdims=True), g.label_full,
                         g.node_set[TRAIN])
    want, line_a = _ring_single(g, y0, tag)
    _detail(line_a)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ring4_")
    try:
        spec = dict(dir=tmp, tag="nccl4", cs_graph=os.path.join(tmp, "cs.npz"),
                    smooth_graph=os.path.join(tmp, "smooth.npz"), smooth=True, cli=None)
        np.savez(spec["cs_graph"], indptr=g.indptr_full, indices=g.indices_full, y0=y0,
                 want0=want[False], want1=want[True])
        np.savez(spec["smooth_graph"], indptr=flickr.indptr_full,
                 indices=flickr.indices_full, feat=flickr.feat_full)
        ranks, _ = _ring_spawn(spec, 4, "cuda", "nccl")
        single, twin = _ring_check(tag, ranks, True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for o in ranks:
        _detail(f"{tag} {json.dumps(o)}")
    cs = ranks[0]["cs"]
    ms = [o["cs"]["0"]["ms"] for o in ranks]
    print(f"{tag} ring C&S - 1 card {single:.1e}, graphed = eager "
          f"{_twin_word([twin], 'atomic index_add_')}, {RING_CALLS - 1} replays/key; "
          f"ms/step e/g a rank "
          + ", ".join(f"{e:.3f}/{gr:.3f}" for e, gr in ms)
          + f"; NCCL share {cs['0']['prof'][1][2]}, overlapped "
          f"{cs['0']['overlap']}; product ms e/g {ranks[0]['product']['ms']}; "
          f"{time.perf_counter() - t0:.1f}s; {_card()}")


def _teardown_rank():
    """One rank of ``phase_parallel_teardown``: a key of the partitioned
    steps' collectives (all-gather, asynchronous reduce-scatter,
    all-reduce) and the ring's shift (``batch_isend_irecv``) warmed up,
    captured and replayed through ``StepGraphs``.
    Returns whether it replayed 3 times, equal to the warm-up; the rank
    then leaves the group (``multihost.shutdown``, ``parallel/launch.py``)."""
    import torch
    from shadow_gnn_torch.parallel import collectives as cc
    from shadow_gnn_torch.parallel import multihost as mh
    from shadow_gnn_torch.train.graphs import StepGraphs
    dev = mh.device()
    sg = StepGraphs(dev, True)
    x = torch.arange(65536.0, device=dev) + mh.rank()
    g = torch.ones(1 << 19, device=dev)

    def step():
        out = cc.all_gather(x * 2)
        rs = cc.reduce_scatter_sum(out + 1, async_op=True)
        shift = cc.ring_shift(x * 3)
        y = g.sum()
        return (cc.all_reduce_sum(torch.cat([rs.wait(), g]))[:8] + y
                + shift.wait()[:8])

    outs = [sg.run(("teardown",), (), step).clone() for _ in range(4)]
    _sync(dev)
    return sg.replays[("teardown",)] == 3 and all(torch.equal(outs[0], o) for o in outs)


def phase_parallel_teardown(world, device="cuda"):
    """[parallel teardown]: ``world`` ranks, one a card, capture and replay
    a key of collectives and a ring shift, then leave the group.  An NCCL communicator
    waits, on destruction, for every graph that holds its collectives: a
    rank that did not destroy its graphs first would never return."""
    from shadow_gnn_torch.parallel import launch
    t0 = time.perf_counter()
    if not launch.spawn(_teardown_rank, world, device, timeout_s=PARALLEL_TIMEOUT_S):
        raise AssertionError("[parallel teardown] the key did not replay equal")
    print(f"[parallel teardown] world {world}: a captured key of collectives "
          f"and a ring shift replayed equal and the ranks left the group in "
          f"{time.perf_counter() - t0:.1f}s")


def main():
    """Every phase, with standard output kept to the summaries
    (``_Stdout``) and the full log in ``LOG_NAME``."""
    global _OUT
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, os.path.dirname(LOG_NAME)), exist_ok=True)
    with open(os.path.join(here, LOG_NAME), "w") as log:
        _OUT = _Stdout(sys.stdout, log)
        sys.stdout = _OUT
        try:
            return _run(here)
        finally:
            sys.stdout = _OUT.real
            _OUT = None


def _run(here):
    import torch
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    profile = "--profile" in sys.argv[1:]
    t_all = time.perf_counter()
    phase_build()
    if "--parallel-nccl4" in sys.argv[1:]:
        # the partitioned runs across four cards, one rank a card
        runs = (("nccl", 4, "cuda"),)
        phase_parallel_teardown(4)
        flickr, products = _flickr_graph(), _products_graph()
        phase_ring_nccl4(products, flickr)
        t = phase_parallel(flickr, "flagship", runs)
        t += phase_parallel(products, "gat", runs)
        print(f"[chip_smoke] [parallel] at NCCL world 4 passed in {t:.1f}s")
        print(_card())
        return 0
    max_abs_err = phase_kernels()
    max_abs_err.update(phase_kernels_gat())
    phase_precision()
    max_abs_err.update(phase_kernels_bf16())
    max_abs_err.update(phase_kernels_gat_bf16())
    max_abs_err["bfs_hops"] = phase_bfs()
    from shadow_gnn_torch import TEST, TRAIN
    from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_t
    b1c, b1c_t, b2b, b3b = _bf16_counts()

    # the flagship SAGE-3: serving, training, uncached serving
    flickr = _flickr_graph()
    tr = _flagship_trainer(flickr)
    reqs, p50 = phase_serve(tr, SERVE_SIZES, packed_spmm, "[serve]")
    serve_bits = tr.caches[TEST][0].adj_bits[:256]
    if profile:
        phase_profile(tr, reqs, p50, (1, 256), "flagship")
    train_launches, step_ms = phase_train(tr, reqs, packed_spmm, packed_spmm_t,
                                          "[train]")
    if profile:
        phase_profile_train(tr, step_ms, "flagship")
    phase_infer_flagship(tr)
    # SAGE aggregates an uncached batch's dense block with torch.bmm
    phase_uncached(tr, reqs, SERVE_SIZES, packed_spmm, 0, "[uncached]")
    phase_time(serve_bits)
    rows = phase_time_train(tr.caches[TRAIN][0].adj_bits[:tr.batch_size].contiguous(),
                            train_launches, max_abs_err)
    del tr, reqs, serve_bits
    torch.cuda.empty_cache()

    # the flagship at --matmul_precision bfloat16: B1c
    tr = _flagship_trainer(flickr, matmul_precision="bfloat16")
    reqs, p50 = phase_serve(tr, SERVE_SIZES, b1c, "[serve bf16]")
    if profile:
        phase_profile(tr, reqs, p50, (1, 256), "flagship bf16")
    train_launches, step_ms = phase_train(tr, reqs, b1c, b1c_t, "[train bf16]")
    if profile:
        phase_profile_train(tr, step_ms, "flagship bf16")
    serve_bits = tr.caches[TEST][0].adj_bits[:256]
    phase_uncached(tr, reqs, SERVE_SIZES, b1c, 0, "[uncached bf16]")
    phase_time(serve_bits, bf16=True)
    rows += phase_time_train(tr.caches[TRAIN][0].adj_bits[:tr.batch_size].contiguous(),
                             train_launches, max_abs_err, bf16=True)
    del tr, reqs, serve_bits
    torch.cuda.empty_cache()

    # the compiled step: graphed against eager twins, f32 and bf16
    t_graphs = phase_graphs(flickr, ("flagship", "flagship bf16"))

    # GCN-3, GIN-3, GATScatter-3 and SIGN on the same graph
    rows += phase_matrix(flickr, max_abs_err, profile)
    # the remaining single-card capabilities on the same graph
    phase_rest(flickr)
    # partitioned training: the flagship under dp and feat
    t_parallel = phase_parallel(flickr, "flagship")
    torch.cuda.empty_cache()

    # the products GAT-5: serving, training, uncached serving, B2/B3 times
    products = _products_graph()
    tr = _gat_trainer(products)
    reqs, p50 = phase_serve(tr, GAT_SIZES, gat_attention, "[gat]")
    if profile:
        phase_profile(tr, reqs, p50, (128,), "gat")
    gat_launches, step_ms = phase_train(tr, reqs, gat_attention, gat_attention_bwd,
                                        "[gat]")
    if profile:
        phase_profile_train(tr, step_ms, "gat")
    phase_uncached(tr, reqs, GAT_SIZES, gat_attention, tr.model_cfg.num_layers,
                   "[gat]")
    rows += phase_time_gat(tr, gat_launches, max_abs_err)
    phase_clocks_gat(tr)
    pred = phase_infer_gat(tr, products)
    # GAT-5 inference over VALID + TEST, graphed against its eager twin
    phase_sampled("gat", products, tr)
    del tr, reqs
    torch.cuda.empty_cache()
    # the ring SpMM and the C&S graphs on [infer]'s matrix; torchrun
    phase_ring(products, pred, flickr)
    del flickr, pred
    torch.cuda.empty_cache()

    # the products GAT-5 at --matmul_precision bfloat16: B2b/B3b
    tr = _gat_trainer(products, matmul_precision="bfloat16")
    reqs, p50 = phase_serve(tr, GAT_SIZES, b2b, "[gat bf16]")
    if profile:
        phase_profile(tr, reqs, p50, (128,), "gat bf16")
    gat_launches, step_ms = phase_train(tr, reqs, b2b, b3b, "[gat bf16]")
    if profile:
        phase_profile_train(tr, step_ms, "gat bf16")
    rows += phase_time_gat(tr, gat_launches, max_abs_err, bf16=True)
    del tr, reqs
    torch.cuda.empty_cache()

    # ... and with --compute_dtype bfloat16 --feat_dtype bfloat16 too
    # (scripts/gat_bench.py's bf16 run): a bf16 feature table and block,
    # no packed path; the label-input select promotes the block back to
    # f32, as JAX's does, so B2b/B3b get f32 values; serve and 1 epoch
    tr = _gat_trainer(products, epochs=1, matmul_precision="bfloat16",
                      compute_dtype="bfloat16", feat_dtype="bfloat16")
    if tr.feat_tab.dtype != torch.bfloat16:
        raise AssertionError("the feature table is not bf16")
    reqs, _ = phase_serve(tr, GAT_SIZES, b2b, "[gat bf16 act]")
    phase_train(tr, reqs, b2b, b3b, "[gat bf16 act]")
    del tr, reqs
    torch.cuda.empty_cache()
    # the compiled step of the GAT-5, graphed against its eager twin
    t_graphs += phase_graphs(products, ("gat",))
    print(f"[graphs] phase {t_graphs:.1f}s (aim 120 s, budget {GRAPHS_BUDGET_S} s)")
    if t_graphs > GRAPHS_BUDGET_S:
        raise AssertionError(f"[graphs] took {t_graphs:.1f}s, over its "
                             f"{GRAPHS_BUDGET_S} s budget")
    # partitioned training: the GAT-5 under edge
    t_parallel += phase_parallel(products, "gat")
    if t_parallel > PARALLEL_BUDGET_S:
        raise AssertionError(f"[parallel] took {t_parallel:.1f}s, over its "
                             f"{PARALLEL_BUDGET_S} s budget")
    del products

    # the flagship on a power-law graph: hub induction, cold steps
    _, bfs_row = phase_power_law(_flickr_power_graph(), profile)
    # the two-branch PPR + khop GAT ensemble
    phase_ensemble(_arxiv_graph(), profile)
    # the collab link model: no packed or GAT kernel on its path
    phase_link(_collab_graph(), profile)
    # [sampled graphs]: the parts run in power, gat, ensemble and link
    t_sampled = _SAMPLED["seconds"]
    print(f"[sampled graphs] phase {t_sampled:.1f}s (aim 90 s, budget "
          f"{SAMPLED_BUDGET_S} s); bfs_hops launches over the graphed twins' "
          f"passes {_SAMPLED['bfs_launches']}")
    if t_sampled > SAMPLED_BUDGET_S:
        raise AssertionError(f"[sampled graphs] took {t_sampled:.1f}s, over its "
                             f"{SAMPLED_BUDGET_S} s budget")
    if not _SAMPLED["bfs_launches"] > 0:
        raise AssertionError("the main paths launched the BFS kernel no time")
    bfs_row.update(launches=_SAMPLED["bfs_launches"],
                   max_abs_err=max_abs_err["bfs_hops"])
    rows.append(bfs_row)
    closing = [
        f"[chip_smoke] all phases passed in {time.perf_counter() - t_all:.1f}s",
        _card(), json.dumps({"kernels": rows}),
        json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})]
    rest = sum(len(line.encode()) + 1 for line in closing)
    note = ("[chip_smoke] standard output {:>7d} bytes with this line and the "
            f"closing lines (limit {STDOUT_LIMIT}); every line in {LOG_NAME}")
    total = _OUT.bytes + len(note.format(0).encode()) + 1 + rest
    print(note.format(total))
    for line in closing:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
