#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``shadow_gnn_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py             # every phase below but `profile`
    python3 chip_smoke.py --profile   # adds the torch.profiler phase

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
8. gat     — the products GAT-5 leaderboard model at full width
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
9. gat bf16 — the same with ``matmul_precision="bfloat16"`` (serving,
             first step, ``train()``: 5 B2b and 5 B3b launches per TRAIN
             step, 5 B2b per evaluation batch and request; B2b/B3b timed
             beside SDPA on bf16 operands, with and without the cast of its
             f32 operands), then with
             ``compute_dtype="bfloat16"`` and ``feat_dtype="bfloat16"``
             as well (a bf16 feature table, the dense path): serving, the
             first step and 1 epoch;
10. power   — the flagship SAGE-3 (f32, ``packed_adj``) on a power-law
             graph of the flickr scale (89,250 nodes, avg deg 10, 500
             features, 7 classes, seed 0, ``power_law=True``; max degree
             9,444), the same cuts, 1 epoch: each mode's induction plan
             printed (TRAIN must plan hub slots), serving through B1a and
             against the plain versions, ``train()`` through B1a/B1b, the
             hub-induced TRAIN blocks of the cache against the ``search``
             strategy on the same node tables (bit for bit), uncached
             serving against cached, then 10 cold (uncached) TRAIN steps
             with ``induce`` timed against the whole step (CUDA events),
             printed as ``[induce] cold step: induce X ms of Y ms``;
11. ensemble — ``configs/arxiv_ensemble_ppr_khop.yml`` at full width
             (GAT, 2 heads, dim 256, 3 layers; a PPR-100 branch, n_pad
             104, and a khop depth-2 budget-10 branch, n_pad 112, softmax
             attention over the two) on an arxiv-width power-law graph
             (169,343 nodes, avg deg 13.7, 128 features, 40 classes, seed
             0), TRAIN 4096, VALID 1024, TEST 2048, 2 epochs: plans,
             serving (6 B2 launches a request; the khop picks seeded per
             request), the first-step check, ``train()`` with B2 and B3
             launched from both branches (counted by block width), the
             khop overflow, and 10 timed TRAIN steps with the khop
             branch's sampling and induction share;
12. profile (``--profile`` only) — torch.profiler over cached requests
             (flagship 1 and 256 ids, GAT 128 ids, the power-law flagship
             1 and 256, the ensemble 1 and 128) and over 5 TRAIN steps of
             each model, f32 and at bf16 precision (the power-law
             flagship's cached and cold steps, the ensemble's steps with
             their sampling): device-busy time
             per request or step (kernels only), its share of the
             unprofiled p50 request or median step, and the kernels and
             host operations that take the most time.

The last three lines of standard output are the card's name and power
limit (nvidia-smi), one JSON object describing every kernel, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository around it, the script exits non-zero and prints no result.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM data sheet, f32 outside the tensor cores
SERVE_SIZES = (1, 8, 64, 256)
EMBED_SIZE = 64
REPEATS = 20
WARMUP = 5
TOL_PROBS = 1e-4                # abs, on probabilities and unit embeddings
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
    """Whether the trainer's model runs the kernels' bf16 levels."""
    cfg = tr.model_cfg
    return "bfloat16" in (cfg.matmul_precision, cfg.compute_dtype)


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
        print(f"[build] {name}: nvcc {' '.join(flags)}\n{log.strip()}")
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
        print(f"[kernels] packed launch B={b} N=208 F={f}: {d.grid} CTAs in "
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
        print(f"[kernels] {'packed_spmm_t' if t else 'packed_spmm'} takes N up "
              f"to {lo}")


def phase_kernels():
    """Every kernel against its plain version on the card; returns the
    worst max |kernel - plain| of each kernel."""
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
                        print(f"[kernels] {name:13s} B={b} N={n} F={f} {norm:4s} "
                              f"p={p:<4} max abs {err:.3e} rel {rel:.3e}")
                        if not rel <= 1e-4:
                            raise AssertionError(f"{name} {norm} N={n} F={f} p={p}: "
                                                 f"rel error {rel} > 1e-4")
                        w_abs, w_rel = worst[name]
                        worst[name] = (max(w_abs, err), max(w_rel, rel))
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
        print(f"[kernels] gat launch at (B, N, H, dh) = {shape}: "
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
                    print(f"[kernels] gat B={b} N={n} H={h} dh={dh} drop={drop}: "
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
        print(f"[precision] bf16_matmul {tuple(a_shape)} @ {tuple(b_shape)}: "
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
                        print(f"[kernels] {name:18s} B={b} N={n} F={f} {norm:4s} "
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
                        print(f"[kernels] gat bf16 level {level} v {str(vdt)[6:]} "
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


def _flagship_trainer(g, epochs=EPOCHS, **precision):
    """The flagship SAGE-3 trainer on the graph ``g``, ``epochs`` epochs;
    ``precision``: the Trainer's ``matmul_precision`` / ``compute_dtype``
    / ``feat_dtype``."""
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer

    t0 = time.perf_counter()
    # configs/flickr_sage_3_ppr.yml, written out (the card machine may
    # lack a yml parser); the synthetic graph has no inductive split
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
    tr = Trainer("flickr_synth", "", _own_splits(g), parse_config(cfg), seed=0,
                 device="cuda", packed_adj=True, **precision)
    _cut_splits(tr, ((TRAIN, TRAIN_NODES), (VALID, VALID_NODES), (TEST, TEST_NODES)))
    torch.cuda.synchronize()
    print(f"[serve] trainer {time.perf_counter() - t0:.1f}s {precision}")
    return tr


def _gat_trainer(g, epochs=EPOCHS, **precision):
    """The products GAT-5 leaderboard model at full width on the
    products-width synthetic graph ``g``; the preprocessing (ppr label
    smoothening of every TRAIN label) runs on the card while the trainer
    is built, before the splits are cut.  ``precision``: the Trainer's
    ``matmul_precision`` / ``compute_dtype`` / ``feat_dtype``."""
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer
    # configs/products_gat_5_ppr_leaderboard.yml, written out; `end` cut
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
    t0 = time.perf_counter()
    tr = Trainer("products_synth", "", _own_splits(g), parse_config(cfg), seed=0,
                 device="cuda", **precision)
    _cut_splits(tr, ((TRAIN, GAT_TRAIN), (VALID, GAT_VALID), (TEST, GAT_TEST)))
    torch.cuda.synchronize()
    log = tr.preproc_log
    print(f"[gat] {precision} trainer {time.perf_counter() - t0:.1f}s; "
          f"preprocessing: label smoothening {log['label_smoothen_s']:.2f}s, "
          f"{log['label_smoothen_steps']} iterations; features "
          f"{tr.dim_feat_smooth} + label inputs {tr.dim_label_smooth}")
    if not 1 < log["label_smoothen_steps"] < 100:
        raise AssertionError("the ppr label smoothening did not converge "
                             "within its 100 iterations")
    if tr.model_cfg.mulhead != 4 or not tr.branches[0]["cfg"][TRAIN].add_self_edge:
        raise AssertionError("the GAT-5 trainer lost its heads or self edges")
    return tr


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
    print(f"{tag} PPR tables {secs['ppr_s']:.2f}s, cache build "
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
        print(f"{tag} predict_nodes {s:3d} ids: p50 {_median(lat[s]):.2f} ms, "
              f"max {max(lat[s]):.2f} ms over {REPEATS} requests")
    print(f"{tag} {fwd.__name__} launches {launches} over {n_req} requests; "
          f"peak device memory while serving {peak / 2**30:.2f} GiB")
    if launches != n_layers * n_req:
        raise AssertionError(f"expected {n_layers * n_req} {fwd.__name__} "
                             f"launches, got {launches}")

    # the same requests through the plain versions on the card
    with _plain_versions(_rounded(tr)):
        d_plain = _max_diff(lambda ids: tr.predict_nodes(ids, TEST), reqs, probs)
        d_plain_emb = float(np.abs(
            tr.embed_nodes(reqs[EMBED_SIZE][0], TEST)[0] - emb).max())
    print(f"{tag} max |kernel - plain|: probabilities {d_plain:.3e}, "
          f"embeddings {d_plain_emb:.3e}")
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


def _grad_error(grads, want):
    """(worst max |g - want| / max |want| over the parameters, its name)."""
    return max(((grads[k] - want[k]).abs().max().item()
                / max(want[k].abs().max().item(), 1e-30), k) for k in want)


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
            with _Swap((layers, "gat_attention", recorded)):
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
                             for k, p in tr.model.named_parameters()}, kinks

    n_layers = _per_pass(tr)
    before = (fwd.launches, bwd.launches)
    loss_k, grads_k, kinks_k = one_step()
    got = (fwd.launches - before[0], bwd.launches - before[1])
    if got != (n_layers, n_layers):
        raise AssertionError(f"a kernel step launched {got} (forward, backward)")
    with _plain_versions(_rounded(tr)):
        loss_p, grads_p, kinks_p = one_step()
    with _plain_backwards():
        loss_b, grads_b, _ = one_step()
    tr.model.load_state_dict(state)
    tr.model.zero_grad(set_to_none=True)
    tr.model.eval()
    crossed = {}
    for (kind, x), (_, y) in zip(kinks_k, kinks_p):
        n, total = crossed.get(kind, (0, 0))
        crossed[kind] = (n + int((x != y).sum()), total + x.numel())
    return dict(loss_k=loss_k, loss_p=loss_p, loss_b=loss_b,
                err_p=_grad_error(grads_k, grads_p),
                err_b=_grad_error(grads_k, grads_b), n_grads=len(grads_p),
                crossed=crossed)


def _first_step_agreement(tr, fwd, bwd, tag):
    """Kernels against plain versions on the first TRAIN step: the loss
    within 1e-5 relative; the gradients of the backward kernels within
    1e-4 of their max of the plain backwards' under the kernels' own
    forward; and the all-plain gradients within 1e-4 of their max when
    the two forwards crossed no kink.  Where they did, the all-plain
    gradients are held instead on a witness: the same model with a
    smooth activation (elu) and no max readout (residue none, center
    pooling), its weights drawn from seed 0, at the first of three
    dropout seeds whose step crosses no kink.  A model at the bf16 levels
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
    print(f"{tag} first step, kernels vs plain: loss {r['loss_k']:.7f} vs "
          f"{r['loss_p']:.7f} (rel {rel_loss:.2e}); worst gradient error "
          f"{err_p:.2e} of its max ({name_p}) over {r['n_grads']} parameters"
          f"{' (kinks crossed: not held)' if n_crossed else ''}; backward "
          f"kernels vs plain backwards (same forward, loss {r['loss_b']:.7f}): "
          f"{err_b:.2e} ({name_b}); kinks the two forwards cross: "
          + (", ".join(f"{kind} {n} of {total}"
                       for kind, (n, total) in r["crossed"].items()) or "none"))
    _, tol_loss, tol_grad = _tols(tr)
    if not (rel_loss <= tol_loss
            and abs(r["loss_b"] - r["loss_k"]) <= 1e-6 * abs(r["loss_k"])
            and err_b <= tol_grad and (n_crossed or err_p <= tol_grad)):
        raise AssertionError("kernel and plain training steps differ")
    return n_crossed == 0


@contextlib.contextmanager
def _smooth_witness(tr):
    """Within the block the trainer holds a model of its configuration
    with the elu activation (the ensemble aggregator's too), residue none
    and center pooling, its random weights drawn from seed 0 as the
    trainer's were."""
    import dataclasses
    import torch
    from shadow_gnn_torch.nn.layers import init_params
    from shadow_gnn_torch.nn.model import DeepGNN
    saved = tr.model_cfg, tr.model
    tr.model_cfg = dataclasses.replace(tr.model_cfg, act="elu", residue="none",
                                       pooling="center", ensemble_act="elu")
    tr.model = DeepGNN(tr.model_cfg)
    init_params(tr.model, torch.Generator().manual_seed(0))
    tr.model.to(tr.device).eval()
    try:
        yield
    finally:
        tr.model_cfg, tr.model = saved


def phase_train(tr, reqs, fwd, bwd, tag):
    """Trainer.train() on the card through the kernels (the main path of
    training), with every step's launches of ``fwd`` and ``bwd`` checked.
    Returns (launches per kernel, epoch-1 median step ms)."""
    import numpy as np
    import torch
    from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID

    for mode in (TRAIN, VALID):
        secs = tr.prepare_serving(mode)
        print(f"{tag} {MODE2STR[mode]}: PPR tables {secs['ppr_s']:.2f}s, cache "
              f"build {secs['cache_s']:.2f}s ({len(tr.entity_set[mode])} roots)")
    _first_step_agreement(tr, fwd, bwd, tag)
    n_layers = _per_pass(tr)

    steps, evals, losses, epochs = [], [], [], []
    orig = (tr._train_step, tr._eval_step, tr.run_epoch)

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
        stats = orig[2](epoch, mode, status)
        epochs.append((epoch, mode, status, time.perf_counter() - t0, stats))
        return stats

    tr._train_step = counted(orig[0], (n_layers, n_layers), steps)
    tr._eval_step = counted(orig[1], (n_layers, 0), evals)
    tr.run_epoch = run_epoch
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts at 0 just before, read just after
    fwd.launches = bwd.launches = 0
    t0 = time.perf_counter()
    try:
        final = tr.train()
        torch.cuda.synchronize()
    finally:
        del tr._train_step, tr._eval_step, tr.run_epoch
    wall = time.perf_counter() - t0
    launches = {fwd.__name__: fwd.launches, bwd.__name__: bwd.launches}
    peak = torch.cuda.max_memory_allocated()

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
    moved = sum(not torch.equal(p0[k], v) for k, v in tr.model.state_dict().items())
    if moved == 0:
        raise AssertionError("training moved no parameter")

    step_ms = [a.elapsed_time(b) for a, b in steps]
    late_ms = step_ms[nb:] or step_ms       # epoch 1 on; all of a 1-epoch run
    for epoch, mode, status, secs, stats in epochs:
        if mode == TRAIN and status == "running":
            acc = {k: v for k, v in stats.items() if k != "loss"}
            print(f"{tag} ep {epoch} TRAIN: loss {stats['loss']:.5f}, "
                  + ", ".join(f"{k} {v:.5f}" for k, v in acc.items())
                  + f", {secs:.2f}s, {nb * tr.batch_size / secs:.0f} subgraphs/s")
    print(f"{tag} {len(steps)} TRAIN steps, {len(evals)} eval batches in "
          f"{wall:.2f}s; step (CUDA events) median {_median(step_ms):.3f} ms, "
          f"epoch-1 median {_median(late_ms):.3f} ms, max "
          f"{max(step_ms):.3f} ms; peak device memory {peak / 2**30:.2f} GiB")
    print(f"{tag} launches over train(): {fwd.__name__} {launches[fwd.__name__]}"
          f" ({n_layers} per step and per eval batch), {bwd.__name__} "
          f"{launches[bwd.__name__]} ({n_layers} per step); {moved} parameters "
          f"moved")

    # serving still answers, through the kernel, after training
    before = fwd.launches
    p = tr.predict_nodes(reqs[64][0], TEST)
    _check_probs(p, 64, tr.num_classes)
    if fwd.launches != before + n_layers:
        raise AssertionError(f"predict_nodes after training did not launch "
                             f"{fwd.__name__} {n_layers} times")
    return launches, _median(late_ms)


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
                print(f"[time] {name:18s} rw B={b} N={n} F={f} nnz={nnz}: kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm "
                      f"{library_ms:.4f} ms{_cast_note(bf16, call_ms)}, bound "
                      f"{bound_ms:.4f} ms ({bound_by}: {byts / 1e6:.1f} MB, "
                      f"{ops / 1e9:.3f} GFLOP)")


def phase_time_train(bits, launches, max_abs_err, bf16=False):
    """Both kernels at the training batch (B=64) on the cached TRAIN
    bits, rw norm, dropedge 0.05 (``bf16``: their bf16 mode, B1c); the
    JSON rows come from F=500."""
    import torch
    from shadow_gnn_torch.ops.normalize import adj_norm_rw
    from shadow_gnn_torch.ops.packed import (packed_spmm, packed_spmm_plain,
                                             packed_spmm_t)
    from shadow_gnn_torch.sampling.cache import unpack_bits
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, n, nbytes = bits.shape
    seed = 12345
    adj_n = adj_norm_rw(unpack_bits(bits, n), seed, DROPEDGE)
    adj_t = adj_n.transpose(1, 2)
    nnz = int((adj_n > 0).sum())
    rows = []
    for f in (500, 256):
        x = torch.randn(b, n, f, device="cuda", generator=gen)
        for name, fn, lib, t in (("packed_spmm", packed_spmm, adj_n, False),
                                 ("packed_spmm_t", packed_spmm_t, adj_t, True)):
            ms = _time_ms(lambda: fn(bits, x, "rw", DROPEDGE, seed, bf16=bf16))
            plain_ms = _time_ms(lambda: packed_spmm_plain(bits, x, "rw", DROPEDGE,
                                                          seed, t, bf16))
            library_ms, call_ms = _library_ms(lib, x, bf16)
            name += "_bf16" if bf16 else ""
            byts = b * (n * nbytes + 2 * n * f * 4)
            # forward: gather-adds + the 1/deg scale; transposed: a
            # multiply-add per surviving entry
            ops = 2 * nnz * f if t else nnz * f + b * n * f
            bound_ms, bound_by = _bound(byts, ops)
            print(f"[time] {name:13s} rw p={DROPEDGE} B={b} N={n} F={f} "
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
                    "launches": launches[name], "max_abs_err": max_abs_err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms,
                    "library_call_ms": call_ms})
    return rows


def _profile(label, fn, n, wall_ms):
    """torch.profiler over n calls of fn: device-busy time per call, its
    share of the unprofiled ``wall_ms``, and the top kernels and host
    operations."""
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
    print(f"[phases] {name}: span {t[:, k].max() - t[:, 0].min():.2f} us over "
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
        print(f"[phases] clusters of {cl}: gat_attention {fwd_ms:.4f} ms, "
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
        print(f"[time] {name:22s} B={b} N={n} H={h} dh={dh} p={GAT_DROPEDGE} "
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
    """Device-busy share of a TRAIN step: a profile of 5 steps against
    the main path's epoch-1 median step time (``step_ms``)."""
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.train.pipeline import EpochRNG
    rng = EpochRNG.from_seed(11, tr.device)
    nb = len(tr.entity_set[TRAIN]) // tr.batch_size
    batches = [_train_batch(tr, tr.batch_size * (i % nb)) for i in range(5)]
    tr.model.train()
    tr._train_step(*batches[0], rng)                    # warm
    _profile(f"{tag} TRAIN step (B={tr.batch_size})",
             lambda i: tr._train_step(*batches[i], rng), 5, step_ms)
    tr.model.eval()


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
            print(f"{tag} plan {MODE2STR[mode]} branch {i}: "
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
    b, ent = tr.batch_size, np.asarray(tr.entity_set[TRAIN])
    rng = EpochRNG.from_seed(seed, tr.device)

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
    timed with CUDA events: the whole step, and within it every
    ``sample_subgraphs`` call (by sampler) and every ``induce``.  Returns
    the medians {"step", "sample <method>", "induce <method>"} in ms and
    the summed induction overflow."""
    import torch
    from shadow_gnn_torch.sampling import samplers
    from shadow_gnn_torch.train import pipeline
    rec, overflow = [], [0]

    def timed(fn, kind, cfg_at):
        def wrapper(*args, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            rec.append((f"{kind} {args[cfg_at].method}", ev))
            if kind == "induce":
                overflow[0] += out.overflow
            return out
        return wrapper

    step, steps = _step_fn(tr), []
    tr.model.train()
    with _Swap((pipeline, "sample_subgraphs", timed(pipeline.sample_subgraphs,
                                                    "sample", 0)),
               (samplers, "induce", timed(samplers.induce, "induce", 4))):
        for i in range(n_steps + 1):
            first = len(rec)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            step(i)
            ev[1].record()
            steps.append((ev, first, len(rec)))
    torch.cuda.synchronize()
    tr.model.eval()
    per = {}
    for ev, first, last in steps[1:]:
        one = {"step": ev[0].elapsed_time(ev[1])}
        for key, e in rec[first:last]:
            one[key] = one.get(key, 0.0) + e[0].elapsed_time(e[1])
        for key, ms in one.items():
            per.setdefault(key, []).append(ms)
    return {k: _median(v) for k, v in per.items()}, overflow[0]


def _profile_steps(tr, label, wall_ms):
    """Device-busy share of 5 steps of :func:`_step_fn` (sampling
    included) against their unprofiled median ``wall_ms``."""
    step = _step_fn(tr, seed=11)
    tr.model.train()
    step(0)                                             # warm
    _profile(label, lambda i: step(i + 1), 5, wall_ms)
    tr.model.eval()


def phase_power_law(graph, profile=False):
    """The flagship SAGE-3 (f32, packed) on the power-law flickr-scale
    graph: the plans (TRAIN must take hub slots), cached serving against
    the plain versions and against uncached serving, the hub-induced
    blocks against the search strategy, 1 epoch of ``train()`` through
    B1a/B1b, and cold (uncached) TRAIN steps with ``induce`` timed."""
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
    phase_uncached(tr, reqs, SERVE_SIZES, packed_spmm, 0, tag)
    tr.disable_cache(TRAIN)
    cold, overflow = _timed_steps(tr, COLD_STEPS)
    print(f"[induce] cold step: induce {cold['induce ppr']:.3f} ms of "
          f"{cold['step']:.3f} ms (median of {COLD_STEPS} uncached TRAIN steps, "
          f"B={tr.batch_size}, CUDA events; sample + induce "
          f"{cold['sample ppr']:.3f} ms, overflow {overflow}; the cached "
          f"step's median {step_ms:.3f} ms)")
    if overflow:
        raise AssertionError(f"the exact plan overflowed by {overflow}")
    if profile:
        _profile_steps(tr, "power cold TRAIN step (sampling included)",
                       cold["step"])
    del tr, reqs
    torch.cuda.empty_cache()
    return launches


def _ensemble_trainer(g, epochs=EPOCHS):
    """configs/arxiv_ensemble_ppr_khop.yml at full width (GAT, 2 heads, dim
    256, 3 layers, hop augment, sum residue, mean pooling; a PPR-100 and a
    khop depth-2 budget-10 branch, softmax attention over them; batch 64,
    dropout 0.3, dropedge 0.05) on the arxiv-width power-law graph ``g``,
    TRAIN cut to 4096 nodes, VALID 1024, TEST 2048, random weights."""
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
                 device="cuda")
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
    branches, and timed steps with the khop branch's sampling and
    induction share.  Returns (B2, B3 launches over ``train()``, by
    block width)."""
    import torch
    from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
    from shadow_gnn_torch.train import pipeline
    tag = "[ensemble]"
    tr = _ensemble_trainer(graph)
    _print_plans(tr, tag)
    by_n, tally = {}, {}

    def tallied(*args, **kw):
        out = sample_subgraphs(*args, **kw)
        n, o = tally.get(args[0].method, (0, 0))
        tally[args[0].method] = (n + out.nodes.shape[0], o + out.overflow)
        return out

    sample_subgraphs = pipeline.sample_subgraphs
    with _gat_launches_by_width(by_n), _Swap((pipeline, "sample_subgraphs", tallied)):
        reqs, p50 = phase_serve(tr, GAT_SIZES, gat_attention, tag)
        serve_n = dict(by_n)
        by_n.clear()
        launches, step_ms = phase_train(tr, reqs, gat_attention, gat_attention_bwd,
                                        tag)
    print(f"{tag} B2/B3 launches by block width: serving {serve_n}; the first "
          f"step's checks and train() {by_n}; subgraphs sampled and their "
          f"induction overflow by sampler {tally}")
    want = {(k, n) for k in ("B2", "B3") for n in ENSEMBLE_WIDTHS}
    if not all(by_n.get(key, 0) > 0 for key in want) or not all(
            serve_n.get(("B2", n), 0) > 0 for n in ENSEMBLE_WIDTHS):
        raise AssertionError("B2 / B3 did not launch from both branches")
    timed, overflow = _timed_steps(tr, COLD_STEPS)
    khop = timed["sample khop"]
    print(f"{tag} step median {timed['step']:.3f} ms over {COLD_STEPS} TRAIN steps "
          f"(sampling included; train()'s model-step median {step_ms:.3f} ms): "
          f"khop sample + induce {khop:.3f} ms ({100 * khop / timed['step']:.1f}%), "
          f"of which induce {timed['induce khop']:.3f} ms; khop overflow {overflow}")
    if profile:
        phase_profile(tr, reqs, p50, (1, 128), "ensemble")
        _profile_steps(tr, "ensemble TRAIN step (sampling included)",
                       timed["step"])
    del tr, reqs
    torch.cuda.empty_cache()
    return launches, by_n



def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    profile = "--profile" in sys.argv[1:]
    t_all = time.perf_counter()
    phase_build()
    max_abs_err = phase_kernels()
    max_abs_err.update(phase_kernels_gat())
    phase_precision()
    max_abs_err.update(phase_kernels_bf16())
    max_abs_err.update(phase_kernels_gat_bf16())
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
    del tr, reqs, serve_bits, flickr
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
    del tr, reqs
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
    del tr, reqs, products
    torch.cuda.empty_cache()

    # the flagship on a power-law graph: hub induction, cold steps
    phase_power_law(_flickr_power_graph(), profile)
    # the two-branch PPR + khop GAT ensemble
    phase_ensemble(_arxiv_graph(), profile)
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_all:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
