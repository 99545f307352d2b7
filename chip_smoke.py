#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``shadow_gnn_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py             # every phase below but `profile`
    python3 chip_smoke.py --profile   # adds the torch.profiler phase

Phases, each fatal on failure (an uncaught exception, non-zero exit):

1. build   — compile every hand-written CUDA kernel from ``csrc/`` (one
             nvcc per source, all at once) and the native PPR push;
2. kernels — hold each kernel against its plain PyTorch version on the
             card, at the serving widths (all norms, N 24/37/208, F
             256/500, B=256 at N=208): max |kernel - plain| must stay
             below 1e-4 of max |plain| (the same f32 products, summed
             in another order);
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
             requests served through ``packed_spmm_plain``, and served
             without the cache (sampling and induction per request, the
             dense aggregation);
4. time    — each kernel, its plain version and one PyTorch library call
             of the same function (``torch.bmm`` on the normalised dense
             block), timed with CUDA events on the cached bits at every
             serving batch (8, 64, 256), beside the least time the card
             could take (bytes over 3.35 TB/s, operations over 67
             TFLOP/s f32);
5. profile (``--profile`` only) — torch.profiler over cached requests of
             1 and 256 ids: device-busy time per request and the kernels
             and host operations that take the most time.

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


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _time_ms(fn, rounds=7, iters=20, warmup=5):
    """Median over ``rounds`` of the mean time of ``iters`` back-to-back
    launches, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
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
    """Every kernel against its plain version on the card."""
    import torch
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_plain
    from shadow_gnn_torch.sampling.cache import pack_bits
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_abs = worst_rel = 0.0
    for n in (24, 37, 208):
        b = 256 if n == 208 else 64
        adj = (torch.rand(b, n, n, device="cuda", generator=gen) < 0.05).float()
        adj[:, n // 3] = 0.0                   # an empty row
        bits = pack_bits(adj)
        for f in (256, 500):
            x = torch.randn(b, n, f, device="cuda", generator=gen)
            for norm in ("none", "rw", "sym", "gin"):
                got = packed_spmm(bits, x, norm)
                torch.cuda.synchronize()
                want = packed_spmm_plain(bits, x, norm)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                print(f"[kernels] packed_spmm B={b} N={n} F={f} {norm:4s} "
                      f"max abs {err:.3e} rel {rel:.3e}")
                if not rel <= 1e-4:
                    raise AssertionError(f"packed_spmm {norm} N={n} F={f}: "
                                         f"rel error {rel} > 1e-4")
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    print(f"[kernels] packed_spmm worst abs {worst_abs:.3e} rel {worst_rel:.3e}")
    return worst_abs


def _flagship_trainer():
    import torch
    from shadow_gnn_torch import TEST
    from shadow_gnn_torch.data import make_synthetic_dataset
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer

    t0 = time.perf_counter()
    g = make_synthetic_dataset(num_nodes=89_250, avg_deg=10.0, num_feat=500,
                               num_classes=7, seed=0, power_law=False)
    g.node_set[TEST] = g.node_set[TEST][:4096]
    # configs/flickr_sage_3_ppr.yml, written out (the card machine may
    # lack a yml parser); the synthetic graph has no inductive split
    cfg = {
        "data": {"to_undirected": True, "transductive": True},
        "architecture": {"dim": 256, "aggr": "sage", "loss": "softmax",
                         "num_layers": 3, "act": "relu", "use_label": "none",
                         "feature_smoothen": "none", "label_smoothen": "none",
                         "feature_augment": "hops", "residue": "none",
                         "pooling": "center"},
        "hyperparameter": {"end": 50, "lr": 5e-4, "dropout": 0.45,
                           "dropedge": 0.05, "batch_size": 64},
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
    return tr, reqs, probs, emb, launches, {s: _median(lat[s]) for s in lat}


def phase_uncached(tr, reqs, probs, emb):
    """The same requests without the cache: sample + induce on the card
    per request, dense normalised aggregation (torch.bmm)."""
    import numpy as np
    from shadow_gnn_torch import TEST
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


def phase_time(bits_all, launches, max_abs_err):
    """packed_spmm on the cached bits at every serving batch."""
    import torch
    from shadow_gnn_torch.ops.normalize import adj_norm_rw
    from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_plain
    from shadow_gnn_torch.sampling.cache import unpack_bits
    gen = torch.Generator(device="cuda").manual_seed(1)
    row = None
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
            bytes_ms = byts / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_FLOP_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            print(f"[time] packed_spmm rw B={b} N={n} F={f} nnz={nnz}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{byts / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
            if (b, f) == (256, 500):                 # the widest serving call
                row = {"name": "packed_spmm", "route": "cuda",
                       "source": "shadow_gnn_torch/csrc/packed_spmm.cu",
                       "replaces": "shadow_gnn_tpu/ops/pallas_packed.py:83",
                       "launches": launches, "max_abs_err": max_abs_err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms}
    return row


def phase_profile(tr, reqs, p50):
    """Device-busy time of cached requests, from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from shadow_gnn_torch import TEST
    for s in (1, 256):
        ids_list = reqs[s][:10]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for ids in ids_list:
                tr.predict_nodes(ids, TEST)
            torch.cuda.synchronize()
        kern, host = {}, {}
        for e in prof.events():
            bucket = kern if e.device_type == DeviceType.CUDA else host
            cnt, us = bucket.get(e.name, (0, 0.0))
            own = (e.time_range.elapsed_us() if bucket is kern
                   else e.self_cpu_time_total)
            bucket[e.name] = (cnt + 1, us + own)
        n = len(ids_list)
        busy_ms = sum(us for _, us in kern.values()) / 1e3 / n
        if busy_ms == 0.0:
            print(f"[profile] {s:3d} ids: the profiler saw no device time "
                  "(device-busy share not measured)")
            continue
        print(f"[profile] {s:3d} ids: device busy {busy_ms:.3f} ms per "
              f"request, {sum(c for c, _ in kern.values()) / n:.0f} device "
              f"events per request; unprofiled p50 {p50[s]:.2f} ms -> device "
              f"busy share {busy_ms / p50[s]:.3f}")
        for name, (cnt, us) in sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]:
            print(f"[profile]   device {us / 1e3 / n:8.4f} ms/req "
                  f"{cnt / n:5.1f}x  {name[:90]}")
        for name, (cnt, us) in sorted(host.items(), key=lambda kv: -kv[1][1])[:8]:
            print(f"[profile]   host   {us / 1e3 / n:8.4f} ms/req "
                  f"{cnt / n:5.1f}x  {name[:90]}")


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
    t_all = time.perf_counter()
    phase_build()
    max_abs_err = phase_kernels()
    tr, reqs, probs, emb, launches, p50 = phase_serve()
    from shadow_gnn_torch import TEST
    bits = tr.caches[TEST][0].adj_bits[:256]
    if "--profile" in sys.argv[1:]:
        phase_profile(tr, reqs, p50)
    phase_uncached(tr, reqs, probs, emb)
    kernel = phase_time(bits, launches, max_abs_err)
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_all:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
