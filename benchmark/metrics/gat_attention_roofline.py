"""The GAT attention kernels' share of their roofline
(``csrc/gat_attention.cu``, B2 forward and B3 backward): every launch's
bound over the two kernels' device time.  A launch's bytes at B rows,
padded N, H heads of dh: the scores a_s, a_n, the values, the
normalised and the structural blocks read and the output written
(forward); the backward reads the output and its gradient too and
writes three gradients.  Its operations: the score chain on every
structural entry and dh multiply-adds (2 FLOPs each) a kept entry,
from the reference's mean entries a block; bytes bound it at these
shapes."""
from benchmark import peaks


def read(ctx):
    t, counters, traced, sub = (ctx.get("trace"), ctx.get("counters"), ctx.get("traced"),
                                ctx.get("subgraph"))
    if not t or not counters or not traced or not sub:
        return None
    secs = sum(v for k, v in t["kernel_s"].items() if "gat_fwd_kernel" in k
               or "gat_bwd_kernel" in k)
    fwd = counters.get("gat_attention.launches", 0)
    bwd = counters.get("gat_attention_bwd.launches", 0)
    if secs <= 0 or fwd <= 0:
        return None
    arch = ctx["config"]["train_config"]["architecture"]
    h = int(arch["heads"])
    dh = arch["dim"] // h
    k = int(ctx["config"]["train_config"]["sampler"][-1]["k"][0])
    n = -(-(k + 1) // 8) * 8
    b = ctx["per_rank"]
    att, blk, adjb = 4 * b * h * n, 4 * b * n * h * dh, 4 * b * n * n
    nnz = b * sub["edges"]          # the block's entries, self edges included
    f_ops = h * (5 * nnz + 2 * dh * nnz) + b * n * h * dh
    b_ops = h * (5 * nnz + (4 * dh + 4) * nnz) + 2 * b * n * h * dh
    bound = (fwd * peaks.bound_s(2 * att + 2 * blk + 2 * adjb, f_ops)
             + bwd * peaks.bound_s(4 * att + 4 * blk + 2 * adjb, b_ops))
    return 100.0 * bound / secs
