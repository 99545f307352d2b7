"""The readings that a cell's limits are set from, on a card:

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the program's set-up, warm-up and a
window of one unit, judged against the plain reference (a sound run's
numbers: the lower readings); then the control, the reference in the
program's place with its products in TF32 (the precision below the
configuration's f32), and the half-batch fault, each judged by the
cell's own numbers against the f32 reference from the same state (the
upper readings).  One JSON line a seed, each number beside its limit;
the control has to fail one of them.  The benchmark's own runs do not
run it.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(name: str, seed: int, device: str, overrides=None, root: str = ROOT):
    """{"program": ..., "tf32": ..., "half_batch": ...}: each reading's
    numbers beside the cell's limits, and ``diag``."""
    from benchmark import harness, verify
    cell, entry, out, dev = harness.measure(name, seed, 0.0, False, time.time(), device,
                                            overrides, root=root)
    ref = verify.Reference(cell, seed, dev)
    nums, diag, want = entry.judge(ref, out)
    res = {"program": harness.check_numbers(cell, nums), "diag": diag}
    for fault in ("tf32", "half_batch"):
        res[fault] = harness.check_numbers(cell, entry.control(ref, out, fault, want))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control needs a CUDA card: TF32 exists only there", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    for seed in args.seeds:
        res = readings(args.workload, seed, "cuda")
        fails = {k: sorted(n for n, c in res[k].items() if not c["value"] <= c["limit"])
                 for k in ("program", "tf32", "half_batch")}
        print(json.dumps({"workload": args.workload, "seed": seed, "fails": fails, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
