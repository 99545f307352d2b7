"""Command line: train, reload, infer and post-process with the PyTorch port.

    python -m shadow_gnn_torch.main --configs configs/flickr_sage_3_ppr.yml \
        --dataset flickr --data_dir ./data --log_dir ./logs --seed 1 --packed_adj
    python -m shadow_gnn_torch.main --inference_dir <run dir> --dataset flickr ...
    python -m shadow_gnn_torch.main --postproc_configs cs.yml --dataset arxiv ...

The task dispatch of ``shadow_gnn_tpu/main.py``:
* train (``--configs``; ``--reload_model_dir <run dir>`` starts from
  that run's newest model and optimizer checkpoint);
* inference (``--inference_dir <run dir>``, whose one yml and newest
  checkpoint are read, or ``--inference_configs <yml>`` with the
  checkpoint of ``--reload_model_dir``): one evaluation pass of VALID
  and TEST, and TRAIN too with ``--is_inf_train``;
  ``--compute_complexity_only`` reports the inference cost per node of
  the VALID batches (up to ``--inference_budget`` roots) instead; unlike
  the JAX CLI, which trains when only ``--configs`` is given, the port
  then reports the cost too and does not train;
* post-processing (``--postproc_configs <yml>``, ``--postproc_dir``):
  Correct & Smooth or the subgraph ensemble (``postproc/``).
The flags of those paths are the JAX CLI's (the precision trade
``--matmul_precision bfloat16``, ``--compute_dtype bfloat16``,
``--feat_dtype bfloat16`` among them), plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels).
``--fused_gat auto|on|off`` is accepted; in JAX ``off`` picks XLA's
dense score chain over the Pallas kernel, the same function, and the
port has one implementation of it on the card, the CUDA kernels, which
every value launches.
``--gpu N`` (a no-op in the JAX CLI, kept for the reference CLI) selects
``cuda:N`` when ``--device`` is not given; ``--platform cpu`` means
``--device cpu`` and ``--platform gpu`` (or ``cuda``) the card.
``--device_ppr auto`` and ``host`` run the host PPR push, ``device``
the power iteration on the card (``sampling/ppr.py``).
``--matmul_precision tensorfloat32`` runs the f32 products on TF32
tensor cores and the kernels in their bf16 modes.  ``--data_tarball``
ingests a local dataset archive when the dataset's files are absent,
``--meta_config`` reads the machine meta-config (data and log dirs,
metric map, ``ignore_config_name``, a logger class), and ``--trace_dir``
writes a torch.profiler trace of TRAIN epoch 1.  The checkpoints are
the port's own ``torch.save`` files.

Multi-card training (``parallel/``): ``--partition dp|feat|edge`` trains
and evaluates partitioned, one process a device.  Without
``--distributed`` the command spawns ``--partition_devices`` local ranks
itself (0 = every card; on ``--device cpu`` the count must be given),
where JAX trains over ``jax.devices()`` of one process.  With
``--distributed`` the process joins the group of a launcher (torchrun's
variables, or JAX's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
/ ``JAX_PROCESS_ID``) before anything touches the card, and drives
``cuda:LOCAL_RANK``; ``--partition_devices`` must then be 0 or the world
size.  NCCL cannot put two ranks on one card, so more ranks than cards
is refused.  Rank 0 alone prints, logs and writes the run dir, whose
name it broadcasts.  The JAX CLI's other flags are accepted by name and
refused with an error (``REFUSED_FLAGS``).
"""
from __future__ import annotations

import argparse
import os
import random
import string
import sys
import time
import traceback

from shadow_gnn_torch.train.config import ConfigFileError, read_config_file

# flags of the JAX CLI the port refuses, and why
_TPU_ONLY = "a TPU-only mechanism of the JAX package, not ported by design: "
REFUSED_FLAGS = {
    "chunk_batches": _TPU_ONLY + "the size of a compiled evaluation chunk "
                     "program; the port runs its batches eagerly",
    "prng": _TPU_ONLY + "the JAX PRNG implementation of the masks; the port "
            "draws them from torch.Generator",
}
# --platform -> torch device type
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}
# a --meta_config file that neither the JSON nor the YAML reader parses
MetaConfigError = ConfigFileError


def read_meta_config(path: str) -> dict:
    """The machine meta-config at ``path``: JSON (which is YAML too, and
    needs no PyYAML), else YAML; raises MetaConfigError when neither
    reader parses it."""
    return read_config_file(path, "--meta_config")


def apply_meta_config(args, metric_map: dict):
    """Apply the meta-config of ``args.meta_config`` (the reference
    CONFIG.yml schema) as the JAX CLI does: ``data.dir.local`` and
    ``logging.dir.local`` replace ``--data_dir`` / ``--log_dir``,
    ``data.metric`` updates ``metric_map``, a ``--configs`` file named in
    ``logging.ignore_config_name`` runs as ``--no_log``.  Returns the
    logger class of ``logging.logger.name`` (``module:Class`` or
    ``module.Class``), or None for the port's Logger."""
    meta = read_meta_config(args.meta_config)
    data, logging = meta.get("data") or {}, meta.get("logging") or {}
    if (data.get("dir") or {}).get("local"):
        args.data_dir = data["dir"]["local"]
    if (logging.get("dir") or {}).get("local"):
        args.log_dir = logging["dir"]["local"]
    metric_map.update(data.get("metric") or {})
    if os.path.basename(str(args.configs or "")) in (
            logging.get("ignore_config_name") or []):
        args.no_log = True
    name = (logging.get("logger") or {}).get("name")
    if not name or name in ("Logger", "LoggerBase"):
        return None
    import importlib
    modname, _, clsname = name.rpartition(":" if ":" in name else ".")
    return getattr(importlib.import_module(modname), clsname)


def build_argparser():
    p = argparse.ArgumentParser(description="shaDow-GNN trainer (PyTorch): train, "
                                "reload, infer, post-process")
    p.add_argument("--configs", type=str, default=None,
                   help="training yml (the train task)")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--no_log", action="store_true")
    p.add_argument("--inference_dir", type=str, default=None,
                   help="run dir to evaluate: its one yml and newest checkpoint")
    p.add_argument("--inference_configs", type=str, default=None,
                   help="yml to evaluate (the checkpoint of --reload_model_dir)")
    p.add_argument("--is_inf_train", action="store_true",
                   help="inference evaluates TRAIN as well as VALID and TEST")
    p.add_argument("--reload_model_dir", type=str, default=None,
                   help="run dir whose newest checkpoint training starts from "
                        "(inference reads it when --inference_dir is absent)")
    p.add_argument("--postproc_configs", type=str, default=None,
                   help="post-processing yml: method cs or ensemble")
    p.add_argument("--postproc_dir", type=str, default=None,
                   help="one more run dir for C&S")
    p.add_argument("--compute_complexity_only", action="store_true",
                   help="report the inference cost per node, then stop")
    p.add_argument("--inference_budget", type=int, default=0,
                   help="roots counted by --compute_complexity_only (0 = all)")
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
                   help="accepted as the JAX CLI accepts it, where 'off' picks "
                        "XLA's dense score chain over the Pallas kernel (the "
                        "same function); the port has one implementation of "
                        "the gat/gatscat attention on the card, the CUDA "
                        "kernels of ops/gat.py, and every value launches them")
    p.add_argument("--matmul_precision", type=str, default=None,
                   choices=["bfloat16", "tensorfloat32", "float32"],
                   help="precision of the f32 products: bfloat16 rounds their "
                        "operands to bf16 and sums in f32, tensorfloat32 runs "
                        "them on TF32 tensor cores (f32 on the CPU); both run "
                        "the kernels in their bf16 modes")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="activation dtype (params/logits stay f32)")
    p.add_argument("--feat_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="device feature-table storage dtype; bfloat16 rounds "
                        "the features once at upload")
    p.add_argument("--device", type=str, default=None,
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--platform", type=str, default=None,
                   help="the JAX CLI's backend choice: cpu means --device cpu, "
                        "gpu or cuda the card")
    p.add_argument("--gpu", type=int, default=None,
                   help="accepted for reference-CLI compatibility: the card "
                        "cuda:N when --device is not given")
    p.add_argument("--device_ppr", type=str, default="auto",
                   choices=["auto", "host", "device"],
                   help="PPR precompute: auto and host run the host push, "
                        "device the power iteration on --device")
    p.add_argument("--data_tarball", type=str, default=None,
                   help="a local dataset archive (shaDow, GraphSAINT or OGB raw "
                        "layout) ingested into <data_dir>/<dataset>/ when the "
                        "dataset's files are absent")
    p.add_argument("--meta_config", type=str, default=None,
                   help="machine meta-config (reference CONFIG.yml schema: data "
                        "and log dirs, per-dataset metric, ignore_config_name, "
                        "logging.logger.name); JSON, which is YAML too and needs "
                        "no PyYAML, or YAML")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler trace (Chrome JSON) of TRAIN "
                        "epoch 1 into this dir")
    p.add_argument("--no_pbar", action="store_true",
                   help="accepted for reference-CLI compatibility (no-op)")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group of a launcher (torchrun's RANK, "
                        "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, or "
                        "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                        "JAX_PROCESS_ID); each rank drives cuda:LOCAL_RANK")
    p.add_argument("--partition", type=str, default="none",
                   choices=["none", "dp", "feat", "edge"],
                   help="partitioned training, one process a device: dp = "
                        "data-parallel (replicated storage), feat = + row-sharded "
                        "feature table, edge = graph, features and PPR tables "
                        "all row-sharded")
    p.add_argument("--partition_devices", type=int, default=0,
                   help="ranks of --partition (0 = every card, or the world "
                        "size under --distributed)")
    for name in REFUSED_FLAGS:
        p.add_argument(f"--{name}", default=None, nargs="?", const="",
                       help=argparse.SUPPRESS)
    return p


def _task(args, parser):
    """(task, yml path) by the JAX CLI's dispatch (reference
    main.py:453-463); the yml is None for post-processing."""
    if (args.inference_dir is None and args.inference_configs is None
            and args.postproc_configs is None):
        if args.configs is None:
            parser.error("give --configs to train, --inference_dir or "
                         "--inference_configs to evaluate, or --postproc_configs")
        return "train", args.configs
    if args.inference_dir is None and args.inference_configs is None:
        return "postproc", None
    if args.inference_dir is not None:
        if not os.path.isdir(args.inference_dir):
            parser.error(f"--inference_dir {args.inference_dir} is not a directory")
        ymls = [f for f in os.listdir(args.inference_dir)
                if f.rsplit(".", 1)[-1] in ("yml", "yaml")]
        if len(ymls) != 1:
            parser.error(f"--inference_dir must hold exactly one yml, "
                         f"{args.inference_dir} holds {len(ymls)}")
        return "inference", f"{args.inference_dir}/{ymls[0]}"
    if args.reload_model_dir is None and not args.compute_complexity_only:
        parser.error("--inference_configs needs --reload_model_dir (the run "
                     "dir of the checkpoint to evaluate)")
    return "inference", args.inference_configs


def parse_args(argv=None):
    """The parsed command line, ``device`` resolved (``--platform``, then
    ``--gpu N`` to ``cuda:N``) and ``task`` / ``config_path`` set; exits
    with usage error 2 on a refused flag (``REFUSED_FLAGS``), on a
    platform other than cpu / gpu / cuda or one that contradicts
    ``--device``, on ``--gpu`` with the CPU, or on a task without its
    yml."""
    parser = build_argparser()
    args = parser.parse_args(argv)
    given = [n for n in REFUSED_FLAGS if getattr(args, n) not in (None, False)]
    if given:
        parser.error("refused by the PyTorch package: " + "; ".join(
            f"--{n}: {REFUSED_FLAGS[n]}" for n in given))
    if args.platform is not None:
        plat = PLATFORMS.get(args.platform.lower())
        if plat is None:
            parser.error(f"--platform {args.platform}: the PyTorch package runs "
                         "on cpu or gpu (cuda)")
        if args.device is not None and args.device.split(":")[0] != plat:
            parser.error(f"--platform {args.platform} contradicts --device "
                         f"{args.device}")
        if plat == "cpu" and args.gpu is not None:
            parser.error("--gpu selects a card; it cannot go with --platform cpu")
        if plat == "cpu":
            args.device = "cpu"
    if args.gpu is not None:
        if args.device is not None and args.device.startswith("cpu"):
            parser.error("--gpu selects a card; it cannot go with --device cpu")
        if args.device is None:
            args.device = f"cuda:{args.gpu}"
    if args.device is None:
        args.device = "cuda"
    args.task, args.config_path = _task(args, parser)
    if args.partition_devices < 0:
        parser.error("--partition_devices must be 0 or more")
    if args.partition != "none" and args.task == "postproc":
        parser.error("--partition trains and evaluates; the post-processing "
                     "partitions by its config's n_shards")
    if args.distributed and args.partition == "none":
        parser.error("--distributed trains with --partition dp, feat or edge")
    if (not args.distributed and args.partition != "none"
            and args.device.startswith("cpu") and args.partition_devices == 0):
        parser.error("--partition on --device cpu needs --partition_devices N "
                     "(the ranks to spawn)")
    return args


def _join_group(args):
    """``--distributed``: join the launcher's group (torchrun's variables,
    a world of 1 too; without a launcher, a group of one on a free port)
    and bind the rank's device; ``--partition_devices`` must be 0 or the
    world size.  Returns the rank."""
    from shadow_gnn_torch.parallel import multihost as mh
    dev = args.device.split(":")[0]
    launched = all(os.environ.get(v) for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    world = int(os.environ["WORLD_SIZE"]) if launched else None
    if not mh.initialize(num_processes=world, device=dev):
        mh.initialize(f"127.0.0.1:{mh.free_port()}", 1, 0, device=dev)
    where = (f", joined at {os.environ['MASTER_ADDR']}:"
             f"{os.environ.get('MASTER_PORT', '29500')}" if launched else "")
    print(f"--distributed: rank {mh.rank()} of {mh.world_size()} ({mh.backend()}) "
          f"on {mh.device()}{where}")
    if args.partition_devices not in (0, mh.world_size()):
        raise SystemExit(f"--partition_devices {args.partition_devices} but the "
                         f"process group has {mh.world_size()} ranks")
    args.device = str(mh.device())
    return mh.rank()


def _rank_main(argv):
    """One spawned rank of a ``--partition`` command (the group is
    joined by ``parallel/launch.py``)."""
    return main(list(argv) + ["--distributed"])


def main(argv=None):
    args = parse_args(argv)
    if args.partition != "none" and not args.distributed:
        from shadow_gnn_torch.parallel import launch
        world = launch.local_world(args.device, args.partition_devices)
        dev = "cpu" if args.device.startswith("cpu") else "cuda"
        argv = list(argv) if argv is not None else sys.argv[1:]
        return launch.spawn(_rank_main, world, dev, (argv,))
    rank = _join_group(args) if args.distributed else 0
    if rank > 0:
        # rank 0 alone prints; errors still reach stderr
        sys.stdout = open(os.devnull, "w")
    import numpy as np

    from shadow_gnn_torch import STR2MODE, TEST, TRAIN, VALID
    from shadow_gnn_torch.data.loader import load_data
    from shadow_gnn_torch.train.config import DATA_METRIC, parse_config
    from shadow_gnn_torch.train.logger import Logger
    from shadow_gnn_torch.train.metrics import Metrics
    from shadow_gnn_torch.train.pipeline import Trainer

    if args.seed >= 0:
        np.random.seed(args.seed)
        random.seed(args.seed)
    task = args.task
    print(f"# {'*' * (len(task) + 15)} #\n* PERFORM {task.upper()} TASK *")
    if task == "postproc":
        from shadow_gnn_torch.postproc.driver import run_postproc
        return run_postproc(args)

    metric_map = dict(DATA_METRIC)
    if args.meta_config:
        Logger = apply_meta_config(args, metric_map) or Logger
    parsed = parse_config(args.config_path)
    metrics = Metrics(args.dataset, parsed["arch_gnn"]["loss"] == "sigmoid",
                      metric_map.get(args.dataset, "accuracy"),
                      int(parsed["params_train"]["term_window_size"]))
    timestamp = time.strftime("%Y-%m-%d %H-%M-%S")
    tie = "".join(random.sample(string.ascii_letters + string.digits, 4))
    if args.distributed:
        from shadow_gnn_torch.parallel.collectives import broadcast_object
        timestamp, tie = broadcast_object((timestamp, tie))
    dir_log = (f"{args.log_dir}/{args.dataset}/running/"
               f"{timestamp.replace(' ', '_')}-RAND{tie}")
    # the raw yml goes into the run dir, where --inference_dir and the
    # post-processing read it
    raw_cfg_dump = read_config_file(args.config_path)
    logger = Logger(metrics, dir_log,
                    term_window_size=int(parsed["params_train"]["term_window_size"]),
                    term_window_aggr=parsed["params_train"]["term_window_aggr"],
                    timestamp=timestamp, no_log=args.no_log or rank > 0,
                    config_dump=raw_cfg_dump)
    if args.data_tarball and rank == 0:
        from shadow_gnn_torch.data.converter import DATA_ZOO, ingest_tarball
        spec = DATA_ZOO.get(args.dataset)
        if spec is None or not spec["ALL"].have_all_files(args.data_dir,
                                                          args.dataset):
            print(f"ingesting {args.data_tarball} -> {args.data_dir}/{args.dataset}")
            ingest_tarball(args.data_tarball, args.dataset, args.data_dir)
    if args.distributed:
        from shadow_gnn_torch.parallel.collectives import barrier
        barrier()                     # rank 0's ingestion is on disk
    raw = load_data(args.data_dir, args.dataset, parsed["config_data"])
    trainer = Trainer(args.dataset, args.data_dir, raw, parsed, metrics, logger,
                      seed=max(args.seed, 0), device=args.device,
                      packed_adj=args.packed_adj,
                      matmul_precision=args.matmul_precision,
                      compute_dtype=args.compute_dtype, feat_dtype=args.feat_dtype,
                      use_device_ppr={"auto": None, "device": True,
                                      "host": False}[args.device_ppr],
                      partition=args.partition,
                      partition_devices=args.partition_devices)
    trainer.trace_dir = args.trace_dir
    trainer.eval_train_every = max(1, args.eval_train_every)
    print(f"TOTAL NUM OF PARAMS = "
          f"{sum(p.numel() for p in trainer.model.parameters())}")
    if args.nocache:
        modes = ((TRAIN, VALID, TEST) if args.nocache.lower() == "all"
                 else (STR2MODE[args.nocache.lower()],))
        for m in modes:
            trainer.disable_cache(m)
    if args.compute_complexity_only:
        from shadow_gnn_torch.train.complexity import compute_complexity
        compute_complexity(trainer, num_roots_budget=args.inference_budget)
        return 0
    if task == "inference":
        trainer.load_run(args.inference_dir or args.reload_model_dir)
        trainer.inference((TRAIN, VALID, TEST) if args.is_inf_train
                          else (VALID, TEST))
        return 0
    try:
        if args.reload_model_dir:
            trainer.load_run(args.reload_model_dir, optimizer=True)
        trainer.train(log_test_convergence=args.log_test_convergence)
        status = "finished"
    except KeyboardInterrupt:
        status = "killed"
        print("Pressed CTRL-C! Stopping.")
    except Exception:
        status = "crashed"
        traceback.print_exc()
        if args.distributed:
            raise                     # a failed rank fails the whole run
    finally:
        logger.end_training(status)
    return 0 if status == "finished" else 1


if __name__ == "__main__":
    raise SystemExit(main())
