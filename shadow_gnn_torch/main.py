"""Command line: train on a shaDow-format dataset with the PyTorch port.

    python -m shadow_gnn_torch.main --configs configs/flickr_sage_3_ppr.yml \
        --dataset flickr --data_dir ./data --log_dir ./logs --seed 1 --packed_adj

The train path of ``shadow_gnn_tpu/main.py``, with its flags of that
path, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels).  The JAX CLI's other flags are
accepted by name and refused with an error, because the parts they
select are not ported yet.
"""
from __future__ import annotations

import argparse
import random
import string
import time
import traceback

# flags of the JAX CLI whose parts are not ported yet
UNPORTED_FLAGS = (
    "inference_dir", "inference_configs", "is_inf_train", "postproc_configs",
    "postproc_dir", "compute_complexity_only", "inference_budget",
    "platform", "chunk_batches", "device_ppr", "matmul_precision", "prng",
    "compute_dtype", "feat_dtype", "data_tarball", "meta_config",
    "reload_model_dir", "trace_dir", "distributed", "partition",
    "partition_devices",
)
_SWITCHES = ("is_inf_train", "compute_complexity_only", "distributed")


def build_argparser():
    p = argparse.ArgumentParser(description="shaDow-GNN trainer (PyTorch)")
    p.add_argument("--configs", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--no_log", action="store_true")
    p.add_argument("--nocache", type=str, default=None,
                   help="sample every batch of this mode (train|valid|test|all)")
    p.add_argument("--log_test_convergence", type=int, default=-1)
    p.add_argument("--eval_train_every", type=int, default=1,
                   help="compute train metrics from every Nth batch only")
    p.add_argument("--packed_adj", action="store_true",
                   help="aggregate cached batches from the packed bits "
                        "(the CUDA packed_spmm kernels on the card)")
    p.add_argument("--fused_gat", default="auto", nargs="?", const="on",
                   choices=["auto", "on", "off"],
                   help="GAT attention through the fused kernels (ops/gat.py), "
                        "which the port always launches on the card; 'off' "
                        "(the dense score chain) is not ported")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--no_pbar", action="store_true",
                   help="accepted for reference-CLI compatibility (no-op)")
    for name in UNPORTED_FLAGS:
        if name in _SWITCHES:
            p.add_argument(f"--{name}", action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument(f"--{name}", default=None, nargs="?", const="",
                           help=argparse.SUPPRESS)
    return p


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    given = [n for n in UNPORTED_FLAGS if getattr(args, n) not in (None, False)]
    if args.fused_gat == "off":
        given.append("fused_gat off")
    if given:
        parser.error("not ported to the PyTorch package yet: "
                     + ", ".join(f"--{n}" for n in given)
                     + " (use python -m shadow_gnn_tpu.main)")
    import numpy as np
    import yaml

    from shadow_gnn_torch import STR2MODE, TRAIN, VALID, TEST
    from shadow_gnn_torch.data.loader import load_data
    from shadow_gnn_torch.train.config import DATA_METRIC, parse_config
    from shadow_gnn_torch.train.logger import Logger
    from shadow_gnn_torch.train.metrics import Metrics
    from shadow_gnn_torch.train.pipeline import Trainer

    if args.seed >= 0:
        np.random.seed(args.seed)
        random.seed(args.seed)
    print("# ****************** #\n* PERFORM TRAIN TASK *")
    parsed = parse_config(args.configs)
    metrics = Metrics(args.dataset, parsed["arch_gnn"]["loss"] == "sigmoid",
                      DATA_METRIC.get(args.dataset, "accuracy"),
                      int(parsed["params_train"]["term_window_size"]))
    timestamp = time.strftime("%Y-%m-%d %H-%M-%S")
    tie = "".join(random.sample(string.ascii_letters + string.digits, 4))
    dir_log = (f"{args.log_dir}/{args.dataset}/running/"
               f"{timestamp.replace(' ', '_')}-RAND{tie}")
    # the raw training yml goes into the run dir
    with open(args.configs) as f:
        raw_cfg_dump = yaml.safe_load(f)
    logger = Logger(metrics, dir_log,
                    term_window_size=int(parsed["params_train"]["term_window_size"]),
                    term_window_aggr=parsed["params_train"]["term_window_aggr"],
                    timestamp=timestamp, no_log=args.no_log,
                    config_dump=raw_cfg_dump)
    raw = load_data(args.data_dir, args.dataset, parsed["config_data"])
    trainer = Trainer(args.dataset, args.data_dir, raw, parsed, metrics, logger,
                      seed=max(args.seed, 0), device=args.device,
                      packed_adj=args.packed_adj)
    trainer.eval_train_every = max(1, args.eval_train_every)
    print(f"TOTAL NUM OF PARAMS = "
          f"{sum(p.numel() for p in trainer.model.parameters())}")
    if args.nocache:
        modes = ((TRAIN, VALID, TEST) if args.nocache.lower() == "all"
                 else (STR2MODE[args.nocache.lower()],))
        for m in modes:
            trainer.disable_cache(m)
    try:
        trainer.train(log_test_convergence=args.log_test_convergence)
        status = "finished"
    except KeyboardInterrupt:
        status = "killed"
        print("Pressed CTRL-C! Stopping.")
    except Exception:
        status = "crashed"
        traceback.print_exc()
    finally:
        logger.end_training(status)
    return 0 if status == "finished" else 1


if __name__ == "__main__":
    raise SystemExit(main())
