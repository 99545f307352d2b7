"""The packed aggregation kernels' share of their roofline
(``csrc/packed_spmm.cu``, B1a forward and B1b transposed): the bound of
every launch of the traced slice (bytes at 3.35 TB/s; each input read
once and the output written once, at B columns a rank, padded N and each
conv's input width F) over the kernels' device time.  A step launches
one of each direction a conv; where the launch counters say otherwise
the launches cannot be told apart and nothing is read."""
from benchmark import peaks


def read(ctx):
    t, counters, traced = ctx.get("trace"), ctx.get("counters"), ctx.get("traced")
    if not t or not counters or not traced:
        return None
    secs = sum(v for k, v in t["kernel_s"].items() if "packed_spmm" in k)
    cfg = ctx["config"]
    arch = cfg["train_config"]["architecture"]
    layers, dim = arch["num_layers"], arch["dim"]
    widths = [cfg["data"]["num_feat"]] + [dim] * (layers - 1)
    steps = traced["steps"]
    fwd = counters.get("packed_spmm.launches", 0)
    bwd = counters.get("packed_spmm_t.launches", 0)
    if secs <= 0 or fwd != steps * layers or bwd not in (0, steps * layers):
        return None
    k = int(cfg["train_config"]["sampler"][-1]["k"][0])
    n = -(-(k + 1) // 8) * 8
    b = ctx["per_rank"]
    bound = sum(peaks.bound_s(peaks.packed_bytes(b, n, f)) for f in widths)
    return 100.0 * bound * (steps + (steps if bwd else 0)) / secs
