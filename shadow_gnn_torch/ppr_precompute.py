"""PPR precompute split over hosts, merged into the reference bin cache.

The port's counterpart of ``scripts/ppr_precompute.py``.  Each host
pushes a round-robin shard of the mode's targets with the port's native
push and writes it beside the final cache; one host then merges the
shards into the ``ppr_float/{neighs,scores}_*.bin`` pair that both
packages (and the reference) read:

    # on each host h of H, in any order:
    python -m shadow_gnn_torch.ppr_precompute --data_dir DATA \\
        --dataset papers100M --mode train --k 400 --epsilon 1e-5 \\
        --shard h --n_shards H
    # then once, on a host that sees every shard:
    python -m shadow_gnn_torch.ppr_precompute ... --merge --n_shards H

``--n_shards 1`` and then ``--merge`` is the plain offline precompute.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from shadow_gnn_torch import MODE2STR, STR2MODE
from shadow_gnn_torch.data import load_data
from shadow_gnn_torch.native import ppr_push_native
from shadow_gnn_torch.sampling import ppr as ppr_mod


def build_argparser():
    ap = argparse.ArgumentParser(description="sharded PPR precompute (PyTorch port)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--mode", default="train", choices=sorted(STR2MODE))
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--alpha", type=float, default=0.85,
                    help="config alpha (flipped internally, as the reference does)")
    ap.add_argument("--epsilon", type=float, default=1e-5)
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--n_shards", type=int, default=1)
    ap.add_argument("--merge", action="store_true",
                    help="merge every shard into the final bin pair")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--transductive", action="store_true", default=True)
    ap.add_argument("--inductive", dest="transductive", action="store_false")
    ap.add_argument("--valedges_as_input", action="store_true")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg_data = {"to_undirected": False, "transductive": args.transductive,
                "valedges_as_input": args.valedges_as_input}
    raw = load_data(args.data_dir, args.dataset, cfg_data)
    mode = STR2MODE[args.mode]
    indptr, indices = raw.adj(mode)
    if raw.prediction_task == "link":
        targets = np.arange(raw.num_nodes, dtype=np.int64)
    else:
        targets = np.asarray(raw.node_set[mode], dtype=np.int64)
    fn, fs = ppr_mod.ppr_cache_paths(
        args.data_dir, args.dataset, args.transductive, MODE2STR[mode],
        args.alpha, args.epsilon, args.k,
        variant="wval" if args.valedges_as_input else "")
    if args.merge:
        t0 = time.time()
        ppr_mod.merge_ppr_shards(fn, fs, raw.num_nodes, args.n_shards, args.k,
                                 args.alpha, args.epsilon)
        print(f"[merge] {args.n_shards} shards -> {fn} ({time.time() - t0:.1f}s)")
        return 0
    sel = ppr_mod.shard_targets(targets, args.shard, args.n_shards)
    print(f"[shard {args.shard}/{args.n_shards}] {sel.size} of {targets.size} "
          f"targets, k={args.k}")
    t0 = time.time()
    tab_n, tab_s = ppr_push_native(indptr, indices, sel, args.k, 1.0 - args.alpha,
                                   args.epsilon, n_threads=args.threads,
                                   as_dense=True)
    dt = time.time() - t0
    ppr_mod.write_ppr_shard(ppr_mod.ppr_shard_path(fn, args.shard, args.n_shards),
                            sel, tab_n, tab_s, args.k, args.alpha, args.epsilon)
    print(f"[shard {args.shard}/{args.n_shards}] done: "
          f"{sel.size / max(dt, 1e-9):.0f} targets/s ({dt:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
