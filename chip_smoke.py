#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``shadow_gnn_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py             # every phase below but `profile`
    python3 chip_smoke.py --profile   # adds the torch.profiler phase

Phases, each fatal on failure (an uncaught exception, non-zero exit):

1. build   — compile every hand-written CUDA kernel from ``csrc/`` (one
             nvcc per source, all at once) and the native PPR push;
2. kernels — hold each kernel against its plain PyTorch version on the
             card: the forward ``packed_spmm`` (all norms, N 24/37/208,
             F 256/500, B=256 at N=208) at dropedge 0, 0.05 and 0.5, the
             transposed ``packed_spmm_t`` at dropedge 0 and 0.05; the GAT
             attention forward ``gat_attention`` (B2) and backward
             ``gat_attention_bwd`` (B3) at N 16/152/408, H 1/4, dh
             8/128/200, with and without dropped edges, on blocks with an
             empty row, a fully dropped row, a row whose max lies on a
             dropped edge and padded tail rows; max |kernel - plain| must
             stay below 1e-4 of max |plain| (d att_self, 0 up to
             rounding, below 1e-4 of the column sums' scale);
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
             cached bits: the forward at every
             serving batch (8, 64, 256), and at the training batch (64)
             the forward with dropedge 0.05 and the transposed kernel;
             beside the least time the card could take (bytes over 3.35
             TB/s, operations over 67 TFLOP/s f32);
7. gat     — the products GAT-5 leaderboard model at full width
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
             ``scaled_dot_product_attention``;
8. profile (``--profile`` only) — torch.profiler over cached requests
             (flagship 1 and 256 ids, GAT 128 ids) and over 5 TRAIN steps
             of each model: device-busy time per request or step
             (kernels only), its share of the unprofiled p50 request or
             median step, and the kernels and host operations that take
             the most time.

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
TRAIN_NODES, VALID_NODES, TEST_NODES = 4096, 1024, 4096
EPOCHS = 2
DROPEDGE = 0.05                 # configs/flickr_sage_3_ppr.yml
GAT_SIZES = (1, 8, 64, 128)
GAT_TRAIN, GAT_VALID, GAT_TEST = 4096, 1024, 2048
GAT_DROPEDGE = 0.1              # configs/products_gat_5_ppr_leaderboard.yml
KINKED_ACTS = ("relu", "prelu", "prelu+", "leakyrelu")   # derivative jumps at 0


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


def _plain_versions():
    """The model aggregates through the plain PyTorch versions instead of
    the kernels (``packed_spmm_plain``, and ``gat_attention_plain`` with
    autograd's backward)."""
    from shadow_gnn_torch.nn import layers, model
    from shadow_gnn_torch.ops.gat import gat_attention_plain
    from shadow_gnn_torch.ops.packed import packed_spmm_plain
    return _Swap((model, "packed_spmm", packed_spmm_plain),
                 (layers, "gat_attention", gat_attention_plain))


def _plain_backwards():
    """The forward kernels stay; the backward kernels (``packed_spmm_t``,
    ``gat_attention_bwd``) give way to their plain versions."""
    from shadow_gnn_torch.ops import gat, packed
    return _Swap(
        (gat, "gat_attention_bwd", gat.gat_attention_bwd_plain),
        (packed, "packed_spmm_t", lambda bits, g, norm, dropedge, seed:
            packed.packed_spmm_plain(bits, g, norm, dropedge, seed, transpose=True)))


def phase_build():
    from shadow_gnn_torch.native import get_lib
    from shadow_gnn_torch.ops import build
    t0 = time.perf_counter()
    logs = build.build()
    t_cuda = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"[build] {name}: nvcc {' '.join(build.NVCC_FLAGS)}\n{log.strip()}")
    t0 = time.perf_counter()
    get_lib()
    print(f"[build] CUDA kernels {t_cuda:.2f}s, native PPR push "
          f"{time.perf_counter() - t0:.2f}s")


def phase_kernels():
    """Every kernel against its plain version on the card; returns the
    worst max |kernel - plain| of each kernel."""
    import torch
    from shadow_gnn_torch.ops.packed import (packed_spmm, packed_spmm_plain,
                                             packed_spmm_t)
    from shadow_gnn_torch.sampling.cache import pack_bits
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"packed_spmm": (0.0, 0.0), "packed_spmm_t": (0.0, 0.0)}
    cases = [("packed_spmm", p) for p in (0.0, DROPEDGE, 0.5)] + \
            [("packed_spmm_t", p) for p in (0.0, DROPEDGE)]
    for n in (24, 37, 208):
        b = 256 if n == 208 else 64
        adj = (torch.rand(b, n, n, device="cuda", generator=gen) < 0.05).float()
        if n == 208:                           # undirected, like cached blocks
            adj = torch.maximum(adj, adj.transpose(1, 2))
        adj[:, n // 3] = 0.0                   # an empty row
        bits = pack_bits(adj)
        for f in (256, 500):
            x = torch.randn(b, n, f, device="cuda", generator=gen)
            for norm in ("none", "rw", "sym", "gin"):
                for name, p in cases:
                    seed = 1000 * n + f
                    t = name == "packed_spmm_t"
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
    for name, (w_abs, w_rel) in worst.items():
        print(f"[kernels] {name} worst abs {w_abs:.3e} rel {w_rel:.3e}")
    return {name: w_abs for name, (w_abs, _) in worst.items()}


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
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"gat_attention": 0.0, "gat_attention_bwd": 0.0}
    n_cases = 0
    for n in (16, 152, 408):
        b = {16: 32, 152: 128, 408: 16}[n]
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
    # beyond the kernels' limits they raise
    try:
        gat_attention(*_gat_case(2, 16, 1, 264, 0.0, gen)[:5])
    except ValueError:
        pass
    else:
        raise AssertionError("gat_attention took dh=264 beyond its limit")
    print(f"[kernels] gat worst over {n_cases} cases: forward abs "
          f"{worst['gat_attention']:.3e}, backward abs "
          f"{worst['gat_attention_bwd']:.3e}")
    return worst


def _cut_splits(tr, cuts):
    """Cut each mode's node set to its first ``keep`` nodes once the
    trainer is built: the preprocessing saw every node of every split
    (every TRAIN label of ``use_label``); the PPR tables, the caches and
    the epochs see the cut sets."""
    for mode, keep in cuts:
        tr.entity_set[mode] = tr.entity_set[mode][:keep]


def _flagship_trainer():
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.data import make_synthetic_dataset
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer

    t0 = time.perf_counter()
    g = make_synthetic_dataset(num_nodes=89_250, avg_deg=10.0, num_feat=500,
                               num_classes=7, seed=0, power_law=False)
    # configs/flickr_sage_3_ppr.yml, written out (the card machine may
    # lack a yml parser); the synthetic graph has no inductive split
    cfg = {
        "data": {"to_undirected": True, "transductive": True},
        "architecture": {"dim": 256, "aggr": "sage", "loss": "softmax",
                         "num_layers": 3, "act": "relu", "use_label": "none",
                         "feature_smoothen": "none", "label_smoothen": "none",
                         "feature_augment": "hops", "residue": "none",
                         "pooling": "center"},
        "hyperparameter": {"end": EPOCHS, "lr": 5e-4, "dropout": 0.45,
                           "dropedge": DROPEDGE, "batch_size": 64},
        "sampler": [{"method": "ppr", "phase": "train", "k": [200],
                     "epsilon": [1e-6]}],
    }
    tr = Trainer("flickr_synth", "", g, parse_config(cfg), seed=0,
                 device="cuda", packed_adj=True)
    _cut_splits(tr, ((TRAIN, TRAIN_NODES), (VALID, VALID_NODES), (TEST, TEST_NODES)))
    torch.cuda.synchronize()
    print(f"[serve] graph + trainer {time.perf_counter() - t0:.1f}s")
    return tr


def _gat_trainer():
    """The products GAT-5 leaderboard model at full width on a
    products-width synthetic graph; the preprocessing (ppr label
    smoothening of every TRAIN label) runs on the card while the trainer
    is built, before the splits are cut."""
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.data import make_synthetic_dataset
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer

    t0 = time.perf_counter()
    g = make_synthetic_dataset(num_nodes=250_000, avg_deg=15, num_feat=100,
                               num_classes=47, seed=0, power_law=False)
    t_graph = time.perf_counter() - t0
    # configs/products_gat_5_ppr_leaderboard.yml, written out; `end` cut
    cfg = {
        "data": {"transductive": True},
        "architecture": {"dim": 512, "aggr": "gat", "heads": 4, "loss": "softmax",
                         "num_layers": 5, "act": "prelu", "feature_augment": "none",
                         "feature_smoothen": "none", "use_label": "no_valid",
                         "label_smoothen": "ppr--concat-0.8", "residue": "max",
                         "pooling": "max"},
        "hyperparameter": {"end": EPOCHS, "lr": 0.001, "dropout": 0.4,
                           "dropedge": GAT_DROPEDGE, "batch_size": 128},
        "sampler": [{"method": "full", "phase": "preprocess"},
                    {"method": "ppr", "phase": "train", "k": [150],
                     "epsilon": [1e-5]}],
    }
    t0 = time.perf_counter()
    tr = Trainer("products_synth", "", g, parse_config(cfg), seed=0, device="cuda")
    _cut_splits(tr, ((TRAIN, GAT_TRAIN), (VALID, GAT_VALID), (TEST, GAT_TEST)))
    torch.cuda.synchronize()
    log = tr.preproc_log
    print(f"[gat] graph {t_graph:.1f}s, trainer {time.perf_counter() - t0:.1f}s; "
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


def _check_emb(e, s, dim):
    import numpy as np
    if not (len(e) == 1 and e[0].shape == (s, dim) and np.isfinite(e[0]).all()
            and np.allclose(np.linalg.norm(e[0], axis=1), 1.0, atol=1e-5)):
        raise AssertionError(f"bad embeddings for a {s}-id request")


def _max_diff(fn, reqs, want):
    import numpy as np
    return max(float(np.abs(np.asarray(fn(reqs[s][0])) - want[s]).max())
               for s in want)


def phase_serve(tr, sizes, fwd, tag):
    """Cached requests of every size through the kernel ``fwd``, with its
    launches counted per request, checked, and held against the plain
    versions.  Returns (requests, p50 ms per size)."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TEST

    secs = tr.prepare_serving(TEST)
    sc = tr.branches[0]["cfg"][TEST]
    n_layers = tr.model_cfg.num_layers
    print(f"{tag} PPR tables {secs['ppr_s']:.2f}s, cache build "
          f"{secs['cache_s']:.2f}s ({len(tr.entity_set[TEST])} roots, "
          f"n_pad {sc.n_pad}, induction {sc.induction} deg_cap {sc.deg_cap})")
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
        _check_emb(e, EMBED_SIZE, tr.model_cfg.dim)
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
    with _plain_versions():
        d_plain = _max_diff(lambda ids: tr.predict_nodes(ids, TEST), reqs, probs)
        d_plain_emb = float(np.abs(
            tr.embed_nodes(reqs[EMBED_SIZE][0], TEST)[0] - emb).max())
    print(f"{tag} max |kernel - plain|: probabilities {d_plain:.3e}, "
          f"embeddings {d_plain_emb:.3e}")
    if not max(d_plain, d_plain_emb) <= TOL_PROBS:
        raise AssertionError(f"kernel and plain serving differ by "
                             f"{max(d_plain, d_plain_emb)}")
    return reqs, {s: _median(lat[s]) for s in lat}


def _train_batch(tr, lo):
    """The cached TRAIN batch of the mode's nodes lo .. lo+B-1 (roots,
    labels, weights 1), as ``Trainer._run_batches`` builds it."""
    import numpy as np
    import torch
    from shadow_gnn_torch import TRAIN
    b = tr.batch_size
    ent = np.asarray(tr.entity_set[TRAIN])[lo:lo + b]
    with torch.no_grad():
        batches, feats = tr._sample_branch_batches(
            TRAIN, torch.as_tensor(ent[:, None], device="cuda"),
            torch.arange(lo, lo + b, device="cuda")[:, None])
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

    n_layers = tr.model_cfg.num_layers
    before = (fwd.launches, bwd.launches)
    loss_k, grads_k, kinks_k = one_step()
    got = (fwd.launches - before[0], bwd.launches - before[1])
    if got != (n_layers, n_layers):
        raise AssertionError(f"a kernel step launched {got} (forward, backward)")
    with _plain_versions():
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
    dropout seeds whose step crosses no kink."""
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
    if not (rel_loss <= 1e-5 and abs(r["loss_b"] - r["loss_k"]) <= 1e-6 * abs(r["loss_k"])
            and err_b <= 1e-4 and (n_crossed or err_p <= 1e-4)):
        raise AssertionError("kernel and plain training steps differ")
    return n_crossed == 0


@contextlib.contextmanager
def _smooth_witness(tr):
    """Within the block the trainer holds a model of its configuration
    with the elu activation, residue none and center pooling, its random
    weights drawn from seed 0 as the trainer's were."""
    import dataclasses
    import torch
    from shadow_gnn_torch.nn.layers import init_params
    from shadow_gnn_torch.nn.model import DeepGNN
    saved = tr.model_cfg, tr.model
    tr.model_cfg = dataclasses.replace(tr.model_cfg, act="elu", residue="none",
                                       pooling="center")
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
    n_layers = tr.model_cfg.num_layers

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
    n_eval = EPOCHS * nbs[VALID] + sum(nbs.values())
    if len(steps) != EPOCHS * nb or len(evals) != n_eval:
        raise AssertionError(f"{len(steps)} train steps and {len(evals)} eval "
                             f"batches, want {EPOCHS * nb} and {n_eval}")
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
    for epoch, mode, status, secs, stats in epochs:
        if mode == TRAIN and status == "running":
            acc = {k: v for k, v in stats.items() if k != "loss"}
            print(f"{tag} ep {epoch} TRAIN: loss {stats['loss']:.5f}, "
                  + ", ".join(f"{k} {v:.5f}" for k, v in acc.items())
                  + f", {secs:.2f}s, {nb * tr.batch_size / secs:.0f} subgraphs/s")
    print(f"{tag} {len(steps)} TRAIN steps, {len(evals)} eval batches in "
          f"{wall:.2f}s; step (CUDA events) median {_median(step_ms):.3f} ms, "
          f"epoch-1 median {_median(step_ms[nb:]):.3f} ms, max "
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
    return launches, _median(step_ms[nb:])


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
    if not max(d, d_emb) <= TOL_PROBS:
        raise AssertionError(f"cached and uncached serving differ by "
                             f"{max(d, d_emb)}")


def _bound(byts, ops):
    bytes_ms = byts / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_time(bits_all):
    """packed_spmm on the cached TEST bits at every serving batch."""
    import torch
    from shadow_gnn_torch.ops.normalize import adj_norm_rw
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_plain
    from shadow_gnn_torch.sampling.cache import unpack_bits
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b in (8, 64, 256):
        bits = bits_all[:b].contiguous()
        _, n, nbytes = bits.shape
        adj_n = adj_norm_rw(unpack_bits(bits, n))
        nnz = int((adj_n > 0).sum())
        for f in (500, 256):
            x = torch.randn(b, n, f, device="cuda", generator=gen)
            ms = _time_ms(lambda: packed_spmm(bits, x, "rw"))
            plain_ms = _time_ms(lambda: packed_spmm_plain(bits, x, "rw"))
            library_ms = _time_ms(lambda: torch.bmm(adj_n, x))
            byts = b * (n * nbytes + 2 * n * f * 4)
            ops = nnz * f + b * n * f           # gather-adds + the 1/deg scale
            bound_ms, bound_by = _bound(byts, ops)
            print(f"[time] packed_spmm rw B={b} N={n} F={f} nnz={nnz}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{byts / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")


def phase_time_train(bits, launches, max_abs_err):
    """Both kernels at the training batch (B=64) on the cached TRAIN
    bits, rw norm, dropedge 0.05; the JSON rows come from F=500."""
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
            ms = _time_ms(lambda: fn(bits, x, "rw", DROPEDGE, seed))
            plain_ms = _time_ms(lambda: packed_spmm_plain(bits, x, "rw", DROPEDGE,
                                                          seed, transpose=t))
            library_ms = _time_ms(lambda: torch.bmm(lib, x))
            byts = b * (n * nbytes + 2 * n * f * 4)
            # forward: gather-adds + the 1/deg scale; transposed: a
            # multiply-add per surviving entry
            ops = 2 * nnz * f if t else nnz * f + b * n * f
            bound_ms, bound_by = _bound(byts, ops)
            print(f"[time] {name:13s} rw p={DROPEDGE} B={b} N={n} F={f} "
                  f"nnz={nnz}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"torch.bmm {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {byts / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
            if f == 500:
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "shadow_gnn_torch/csrc/packed_spmm.cu",
                    "replaces": "shadow_gnn_tpu/ops/pallas_packed.py:"
                                + ("153" if t else "83"),
                    "launches": launches[name], "max_abs_err": max_abs_err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms})
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


def phase_time_gat(tr, launches, max_abs_err):
    """B2 and B3 at the training shape (B=128, N=152, H=4, dh=128) on the
    cached TRAIN blocks, dropedge 0.1, beside their bound, their plain
    versions and scaled_dot_product_attention (forward; its backward as
    forward + backward less forward).  Returns the two JSON rows."""
    import torch
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.ops.gat import (gat_attention, gat_attention_bwd,
                                          gat_attention_bwd_plain,
                                          gat_attention_plain)
    from shadow_gnn_torch.ops.normalize import adj_drop
    from shadow_gnn_torch.sampling.cache import unpack_bits
    gen = torch.Generator(device="cuda").manual_seed(4)
    bits = tr.caches[TRAIN][0].adj_bits[:tr.batch_size].contiguous()
    b, n, _ = bits.shape
    h = tr.model_cfg.mulhead
    dh = tr.model_cfg.dim // h
    adj = unpack_bits(bits, n)
    adj_n = adj_drop(adj, 12345, GAT_DROPEDGE)
    nnz_s, nnz_k = int((adj > 0).sum()), int((adj_n > 0).sum())
    a_s = torch.randn(b, h, n, device="cuda", generator=gen)
    a_n = torch.randn(b, h, n, device="cuda", generator=gen)
    v = torch.randn(b, n, h, dh, device="cuda", generator=gen)
    g = torch.randn(b, n, h, dh, device="cuda", generator=gen)
    args = (a_s, a_n, v, adj_n, adj)
    out = gat_attention_plain(*args)

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
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa(*qkv, attn_mask=mask, scale=1.0)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(*qkv, attn_mask=mask, scale=1.0), qkv, gh)

    with torch.no_grad():
        fwd_ms = _time_ms(lambda: gat_attention(*args))
        fwd_plain = _time_ms(lambda: gat_attention_plain(*args))
        bwd_ms = _time_ms(lambda: gat_attention_bwd(*args, out, g))
        bwd_plain = _time_ms(lambda: gat_attention_bwd_plain(*args, out, g))
        lib_fwd = _time_ms(sdpa_fwd)
    lib_fwd_bwd = _time_ms(sdpa_fwd_bwd)
    lib_bwd = lib_fwd_bwd - lib_fwd
    att, blk, adjb = 4 * b * h * n, 4 * b * n * h * dh, 4 * b * n * n
    # scores on every structural entry (add, subtract, exp, scale, sum),
    # dh multiply-adds per kept entry; backward: g.v and P g per kept
    # entry, g.out per row
    cases = (
        ("gat_attention", fwd_ms, fwd_plain, lib_fwd, "_fwd_kernel",
         2 * att + 2 * blk + 2 * adjb,
         h * (5 * nnz_s + 2 * dh * nnz_k) + b * n * h * dh),
        ("gat_attention_bwd", bwd_ms, bwd_plain, lib_bwd, "_bwd_kernel",
         4 * att + 4 * blk + 2 * adjb,
         h * (5 * nnz_s + (4 * dh + 4) * nnz_k) + 2 * b * n * h * dh))
    line = {"_fwd_kernel": 85, "_bwd_kernel": 101}
    rows = []
    for name, ms, plain_ms, lib_ms, tpu_fn, byts, ops in cases:
        bound_ms, bound_by = _bound(byts, ops)
        note = f" (fwd+bwd {lib_fwd_bwd:.4f} less fwd)" if tpu_fn == "_bwd_kernel" else ""
        print(f"[time] {name:17s} B={b} N={n} H={h} dh={dh} p={GAT_DROPEDGE} "
              f"nnz={nnz_s} kept={nnz_k}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms"
              f"{note}, bound {bound_ms:.4f} ms ({bound_by}: {byts / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} GFLOP)")
        rows.append({
            "name": name, "route": "cuda",
            "source": "shadow_gnn_torch/csrc/gat_attention.cu",
            "replaces": f"shadow_gnn_tpu/ops/pallas_gat.py:{line[tpu_fn]}",
            "launches": launches[name], "max_abs_err": max_abs_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms})
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
    from shadow_gnn_torch import TEST, TRAIN
    from shadow_gnn_torch.ops.gat import gat_attention, gat_attention_bwd
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_t

    # the flagship SAGE-3: serving, training, uncached serving
    tr = _flagship_trainer()
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

    # the products GAT-5: serving, training, uncached serving, B2/B3 times
    tr = _gat_trainer()
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
