#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``shadow_gnn_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py             # every phase below but `profile`
    python3 chip_smoke.py --profile   # adds the torch.profiler phase

Phases, each fatal on failure (an uncaught exception, non-zero exit):

1. build   — compile every hand-written CUDA kernel from ``csrc/`` (one
             nvcc per source, all at once) and the native PPR push;
2. kernels — hold each kernel against its plain PyTorch version on the
             card (all norms, N 24/37/208, F 256/500, B=256 at N=208):
             the forward ``packed_spmm`` at dropedge 0, 0.05 and 0.5, the
             transposed ``packed_spmm_t`` at dropedge 0 and 0.05; max
             |kernel - plain| must stay below 1e-4 of max |plain| (the
             same f32 products, summed in another order; one mask bit
             that differs would show far above that);
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
             requests served through ``packed_spmm_plain``;
4. train   — the same trainer, TRAIN node set cut to its first 4096
             nodes (64 batches of 64) and VALID to 1024, 2 epochs
             (``end`` 2; the yml has 50), dropout 0.45, dropedge 0.05.
             First one TRAIN step's loss and gradients through the
             kernels and through the plain versions, from the same
             parameters, batch, dropout generator and dropedge seed
             (loss within 1e-5 relative, each gradient within 1e-4 of
             its max).  Then ``Trainer.train()`` with the counts set to
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
7. profile (``--profile`` only) — torch.profiler over cached requests of
             1 and 256 ids and over 5 TRAIN steps: device-busy time per
             request or step (kernels only), its share of the unprofiled
             p50 request or median step, and the kernels and host
             operations that take the most time.

The last three lines of standard output are the card's name and power
limit (nvidia-smi), one JSON object describing every kernel, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository around it, the script exits non-zero and prints no result.
"""
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


def _flagship_trainer():
    import torch
    from shadow_gnn_torch import TEST, TRAIN, VALID
    from shadow_gnn_torch.data import make_synthetic_dataset
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer

    t0 = time.perf_counter()
    g = make_synthetic_dataset(num_nodes=89_250, avg_deg=10.0, num_feat=500,
                               num_classes=7, seed=0, power_law=False)
    for mode, keep in ((TRAIN, TRAIN_NODES), (VALID, VALID_NODES),
                       (TEST, TEST_NODES)):
        g.node_set[mode] = g.node_set[mode][:keep]
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
    torch.cuda.synchronize()
    print(f"[serve] graph + trainer {time.perf_counter() - t0:.1f}s")
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


def phase_serve():
    import numpy as np
    import torch
    from shadow_gnn_torch import TEST
    from shadow_gnn_torch.nn import model as model_mod
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_plain

    tr = _flagship_trainer()
    secs = tr.prepare_serving(TEST)
    sc = tr.branches[0]["cfg"][TEST]
    print(f"[serve] PPR tables {secs['ppr_s']:.2f}s, cache build "
          f"{secs['cache_s']:.2f}s ({len(tr.entity_set[TEST])} roots, "
          f"n_pad {sc.n_pad}, induction {sc.induction} deg_cap {sc.deg_cap})")
    rng = np.random.default_rng(0)
    test_ids = np.asarray(tr.entity_set[TEST])
    reqs = {s: [rng.choice(test_ids, s, replace=False) for _ in range(REPEATS)]
            for s in SERVE_SIZES + (EMBED_SIZE,)}
    for s in SERVE_SIZES:                                # warm-up, every size
        for ids in reqs[s][:WARMUP]:
            tr.predict_nodes(ids, TEST)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts at 0 just before, read just after
    packed_spmm.launches = packed_spmm.calls = 0
    lat, probs, n_req = {}, {}, 0
    for s in SERVE_SIZES:
        lat[s] = []
        for ids in reqs[s]:
            before = packed_spmm.launches
            t0 = time.perf_counter()
            p = tr.predict_nodes(ids, TEST)
            lat[s].append((time.perf_counter() - t0) * 1e3)
            n_req += 1
            if packed_spmm.launches != before + 3:
                raise AssertionError(f"a {s}-id request launched packed_spmm "
                                     f"{packed_spmm.launches - before} times")
            _check_probs(p, s, tr.num_classes)
            probs.setdefault(s, p)
    emb = None
    for ids in reqs[EMBED_SIZE][:WARMUP]:
        before = packed_spmm.launches
        e = tr.embed_nodes(ids, TEST)
        n_req += 1
        if packed_spmm.launches != before + 3:
            raise AssertionError("an embed_nodes request did not launch "
                                 "packed_spmm 3 times")
        _check_emb(e, EMBED_SIZE, tr.model_cfg.dim)
        emb = e[0] if emb is None else emb
    launches = packed_spmm.launches
    peak = torch.cuda.max_memory_allocated()

    for s in SERVE_SIZES:
        print(f"[serve] predict_nodes {s:3d} ids: p50 {_median(lat[s]):.2f} ms, "
              f"max {max(lat[s]):.2f} ms over {REPEATS} requests")
    print(f"[serve] packed_spmm launches {launches} over {n_req} requests "
          f"(calls {packed_spmm.calls}); peak device memory while serving "
          f"{peak / 2**30:.2f} GiB")
    if launches != 3 * n_req:
        raise AssertionError(f"expected {3 * n_req} packed_spmm launches, got "
                             f"{launches}")

    # the same requests through the plain version on the card
    model_mod.packed_spmm = packed_spmm_plain
    try:
        d_plain = _max_diff(lambda ids: tr.predict_nodes(ids, TEST), reqs, probs)
        d_plain_emb = float(np.abs(
            tr.embed_nodes(reqs[EMBED_SIZE][0], TEST)[0] - emb).max())
    finally:
        model_mod.packed_spmm = packed_spmm
    print(f"[serve] max |kernel - plain|: probabilities {d_plain:.3e}, "
          f"embeddings {d_plain_emb:.3e}")
    if not max(d_plain, d_plain_emb) <= TOL_PROBS:
        raise AssertionError(f"kernel and plain serving differ by "
                             f"{max(d_plain, d_plain_emb)}")
    return tr, reqs, launches, {s: _median(lat[s]) for s in lat}


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


def _first_step_agreement(tr):
    """One TRAIN step's loss and gradients through the kernels and
    through the plain versions, from the same parameters, batch, dropout
    generator state and dropedge seed."""
    import torch
    from shadow_gnn_torch.nn import model as model_mod
    from shadow_gnn_torch.ops.packed import (packed_spmm, packed_spmm_plain,
                                             packed_spmm_t)
    from shadow_gnn_torch.train.pipeline import EpochRNG
    batch = _train_batch(tr, 0)
    state = {k: v.clone() for k, v in tr.model.state_dict().items()}

    def one_step():
        tr.model.load_state_dict(state)
        tr.model.train()
        tr.model.zero_grad(set_to_none=True)
        loss, _ = tr._forward_loss(*batch, EpochRNG.from_seed(7, tr.device))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone()
                             for k, p in tr.model.named_parameters()}

    before = (packed_spmm.launches, packed_spmm_t.launches)
    loss_k, grads_k = one_step()
    got = (packed_spmm.launches - before[0], packed_spmm_t.launches - before[1])
    if got != (3, 3):
        raise AssertionError(f"a kernel step launched {got} (forward, transposed)")
    model_mod.packed_spmm = packed_spmm_plain
    try:
        loss_p, grads_p = one_step()
    finally:
        model_mod.packed_spmm = packed_spmm
    tr.model.load_state_dict(state)
    tr.model.zero_grad(set_to_none=True)
    tr.model.eval()
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    grad_err = max((grads_k[k] - grads_p[k]).abs().max().item()
                   / max(grads_p[k].abs().max().item(), 1e-30) for k in grads_p)
    print(f"[train] first step, kernels vs plain: loss {loss_k:.7f} vs "
          f"{loss_p:.7f} (rel {rel_loss:.2e}); worst gradient error "
          f"{grad_err:.2e} of its max over {len(grads_p)} parameters")
    if not (rel_loss <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError("kernel and plain training steps differ")


def phase_train(tr, reqs):
    """Trainer.train() on the card through the kernels (the main path of
    training), with every step's launches checked."""
    import numpy as np
    import torch
    from shadow_gnn_torch import MODE2STR, TEST, TRAIN, VALID
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_t

    for mode in (TRAIN, VALID):
        secs = tr.prepare_serving(mode)
        print(f"[train] {MODE2STR[mode]}: PPR tables {secs['ppr_s']:.2f}s, cache "
              f"build {secs['cache_s']:.2f}s ({len(tr.entity_set[mode])} roots)")
    _first_step_agreement(tr)

    steps, evals, losses, epochs = [], [], [], []
    orig = (tr._train_step, tr._eval_step, tr.run_epoch)

    def counted(fn, want, log):
        def step(*args, **kw):
            f0, t0 = packed_spmm.launches, packed_spmm_t.launches
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            got = (packed_spmm.launches - f0, packed_spmm_t.launches - t0)
            if got != want:
                raise AssertionError(f"a step launched {got} (forward, "
                                     f"transposed), want {want}")
            log.append(ev)
            losses.append(out[0])
            return out
        return step

    def run_epoch(epoch, mode, status="running"):
        t0 = time.perf_counter()
        stats = orig[2](epoch, mode, status)
        epochs.append((epoch, mode, status, time.perf_counter() - t0, stats))
        return stats

    tr._train_step = counted(orig[0], (3, 3), steps)
    tr._eval_step = counted(orig[1], (3, 0), evals)
    tr.run_epoch = run_epoch
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts at 0 just before, read just after
    packed_spmm.launches = packed_spmm.calls = packed_spmm_t.launches = 0
    t0 = time.perf_counter()
    try:
        final = tr.train()
        torch.cuda.synchronize()
    finally:
        del tr._train_step, tr._eval_step, tr.run_epoch
    wall = time.perf_counter() - t0
    launches = {"packed_spmm": packed_spmm.launches,
                "packed_spmm_t": packed_spmm_t.launches}
    peak = torch.cuda.max_memory_allocated()

    nbs = {m: -(-len(tr.entity_set[m]) // tr.batch_size)
           for m in (TRAIN, VALID, TEST)}
    nb = nbs[TRAIN]
    # VALID after every epoch, then the final TRAIN, VALID and TEST passes
    n_eval = EPOCHS * nbs[VALID] + sum(nbs.values())
    if len(steps) != EPOCHS * nb or len(evals) != n_eval:
        raise AssertionError(f"{len(steps)} train steps and {len(evals)} eval "
                             f"batches, want {EPOCHS * nb} and {n_eval}")
    want = {"packed_spmm": 3 * (len(steps) + len(evals)),
            "packed_spmm_t": 3 * len(steps)}
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
            print(f"[train] ep {epoch} TRAIN: loss {stats['loss']:.5f}, accuracy "
                  f"{stats['accuracy']:.5f}, {secs:.2f}s, "
                  f"{nb * tr.batch_size / secs:.0f} subgraphs/s")
    print(f"[train] {len(steps)} TRAIN steps, {len(evals)} eval batches in "
          f"{wall:.2f}s; step (CUDA events) median {_median(step_ms):.3f} ms, "
          f"epoch-1 median {_median(step_ms[nb:]):.3f} ms, max "
          f"{max(step_ms):.3f} ms; peak device memory {peak / 2**30:.2f} GiB")
    print(f"[train] launches over train(): packed_spmm {launches['packed_spmm']}"
          f" (3 per step and per eval batch), packed_spmm_t "
          f"{launches['packed_spmm_t']} (3 per step); {moved} parameters moved")

    # serving still answers, through the kernel, after training
    before = packed_spmm.launches
    p = tr.predict_nodes(reqs[64][0], TEST)
    _check_probs(p, 64, tr.num_classes)
    if packed_spmm.launches != before + 3:
        raise AssertionError("predict_nodes after training did not launch "
                             "packed_spmm 3 times")
    return launches, _median(step_ms[nb:])


def phase_uncached(tr, reqs):
    """The same requests without the cache: sample + induce on the card
    per request, dense normalised aggregation (torch.bmm)."""
    import numpy as np
    from shadow_gnn_torch import TEST
    probs = {s: tr.predict_nodes(reqs[s][0], TEST) for s in SERVE_SIZES}
    emb = tr.embed_nodes(reqs[EMBED_SIZE][0], TEST)[0]
    tr.disable_cache(TEST)
    lat = []
    for ids in reqs[256][:WARMUP]:
        t0 = time.perf_counter()
        tr.predict_nodes(ids, TEST)
        lat.append((time.perf_counter() - t0) * 1e3)
    d = _max_diff(lambda ids: tr.predict_nodes(ids, TEST), reqs, probs)
    d_emb = float(np.abs(tr.embed_nodes(reqs[EMBED_SIZE][0], TEST)[0]
                         - emb).max())
    print(f"[uncached] predict_nodes 256 ids: p50 {_median(lat):.2f} ms over "
          f"{len(lat)} requests; max |cached kernel - uncached dense|: "
          f"probabilities {d:.3e}, embeddings {d_emb:.3e}")
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


def phase_profile(tr, reqs, p50):
    """Device-busy time of cached requests, from a torch.profiler trace."""
    from shadow_gnn_torch import TEST
    for s in (1, 256):
        _profile(f"{s:3d} ids", lambda i: tr.predict_nodes(reqs[s][i], TEST), 10,
                 p50[s])


def phase_profile_train(tr, step_ms):
    """Device-busy share of a TRAIN step: a profile of 5 steps against
    the main path's epoch-1 median step time (``step_ms``)."""
    from shadow_gnn_torch import TRAIN
    from shadow_gnn_torch.train.pipeline import EpochRNG
    rng = EpochRNG.from_seed(11, tr.device)
    nb = len(tr.entity_set[TRAIN]) // tr.batch_size
    batches = [_train_batch(tr, tr.batch_size * (i % nb)) for i in range(5)]
    tr.model.train()
    tr._train_step(*batches[0], rng)                    # warm
    _profile("TRAIN step (B=64)", lambda i: tr._train_step(*batches[i], rng),
             5, step_ms)
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
    tr, reqs, _, p50 = phase_serve()
    from shadow_gnn_torch import TEST, TRAIN
    serve_bits = tr.caches[TEST][0].adj_bits[:256]
    if profile:
        phase_profile(tr, reqs, p50)
    train_launches, step_ms = phase_train(tr, reqs)
    if profile:
        phase_profile_train(tr, step_ms)
    phase_uncached(tr, reqs)
    phase_time(serve_bits)
    rows = phase_time_train(tr.caches[TRAIN][0].adj_bits[:tr.batch_size].contiguous(),
                            train_launches, max_abs_err)
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
