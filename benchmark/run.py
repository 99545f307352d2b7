"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the program (``shadow_gnn_torch``).  The cell's cards must be
there: without CUDA, or with fewer cards than the cell asks for, the
run exits non-zero and prints no result.  The last line of standard
output is the result (JSON); the compared numbers, each beside its
limit, are also the last lines of standard error.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness, hygiene
    bad = hygiene.scan()
    if bad:
        print(f"benchmark sources import forbidden modules: {bad}", file=sys.stderr)
        return 3
    import torch
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    res = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    forbidden = sorted(set(hygiene.loaded_forbidden()) | set(res.pop("_forbidden")))
    graphs = res.pop("_graphs")
    split = res.pop("_setup_split")
    diag = res.pop("_diag")
    e2e = res.pop("_end_to_end")
    if forbidden:
        print(f"forbidden modules loaded: {forbidden}", file=sys.stderr)
        return 4
    import subprocess
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        limit = "nvidia-smi unavailable"
    print(f"[graphs] {graphs}; [card] {limit}", file=sys.stderr)
    print("[setup] " + ", ".join(f"{k} {v:.3f}s" for k, v in split.items()),
          file=sys.stderr)
    print(f"[diag] {json.dumps(diag)}", file=sys.stderr)
    # the window's end-to-end values, in a traced run too (its slice
    # comes after the window)
    print(f"[end_to_end] {json.dumps(e2e)}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
