"""Fused masked GAT attention over subgraph blocks.

Per subgraph b and head h, with ``S[i,j] = att_self[i] + att_neigh[j]``
on the structural edges (``adj_struct > 0``)::

    e[i,j] = exp(S[i,j] - rowmax_i S) * adj_norm[i,j]
    out[i] = (sum_j e[i,j] values[j]) / clip(sum_j e[i,j], 1e-10)

with the row max taken over the structural edges only (0 for a row
without one), so dropped edges (``adj_norm == 0``) still set the max.

* on CUDA tensors the forward launches the hand-written kernel B2 and
  the backward the kernel B3 (``csrc/gat_attention.cu``), or they raise;
* on CPU tensors they compute :func:`gat_attention_plain` and
  :func:`gat_attention_bwd_plain`, the plain PyTorch versions (the dense
  [B, H, N, N] chain), which the tests hold against the JAX package and
  ``chip_smoke.py`` holds the kernels against on the card.

Two levels below f32 (the ``--matmul_precision bfloat16`` trade, B2b
and B3b; ``pallas_gat.py:_scores``, ``_fwd_kernel``, ``_bwd_kernel``):

* ``bf16``: the operands of the products are rounded to bf16 and summed
  in f32 (e and v forward; g and v in g.v, P and g in dv backward);
  D, r = g.out and ds = P (g.v - r) stay f32 with the unrounded P;
* ``bf16_scores`` (needs ``bf16``): also ``e = bf16(exp(bf16(S - rm))) *
  adj_norm``, with D the f32 sum of the rounded e.

Values may be bf16 (the model's bf16 activations): they are widened to
f32 on the way into the kernels (exactly) and ``dv`` comes back in
their dtype.

Counterpart of ``shadow_gnn_tpu/ops/pallas_gat.py`` (``gat_attention``
with its custom VJP, node-major values, every level).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from shadow_gnn_torch.ops.precision import round_bf16

THREADS = 512           # 16 warps a CTA, both kernels
MAX_DH = 256            # a lane owns 4 features of each 128
MAX_SMEM = 232_448      # dynamic shared memory one block may use on sm_90
# two CTAs an SM: (228 KB less 1 KB reserved per CTA) / 2
SMEM_TWO_PER_SM = 115_712
EDGE_SLOT_BYTES = 8     # an edge slot: e, then ds (f32); its row and column (u16)
MIN_SMEM_EDGES = 1024   # slots a staged slice of v or g must leave room for
MAX_N = 907             # the backward's two bitmaps fit one block


class GatLaunch(NamedTuple):
    """Launch shapes of both kernels (``launch_dims``)."""
    fwd_grid: int       # B * H * split CTAs, b-major
    fwd_cluster: int    # CTAs of a subgraph that share its bitmap
    split: int          # the forward's dh split: a CTA owns dh / split features
    fwd_edge_cap: int   # edge slots in shared memory
    fwd_smem: int
    bwd_grid: int       # B * H CTAs, b-major
    bwd_cluster: int
    g_staged: bool      # the backward stages g's head slice in shared memory
    bwd_edge_cap: int
    bwd_smem: int
    chunks: int         # 128-feature chunks of a (node, head) row
    threads: int


def _fwd_base(n: int) -> int:
    """The forward's shared memory without v and the edge slots: mbarrier |
    a_n, a_s, rm, D [n] f32 | rowstart [n+1] i32 | scan [32] i32 | bitmap
    [n, ceil(n/32)] u32."""
    return 16 + 16 * n + 4 * (n + 1) + 128 + 4 * n * -(-n // 32)


def _bwd_base(n: int) -> int:
    """The backward's shared memory without g and the edge slots: mbarrier |
    a_n, a_s, rm, D, r [n] f32 | colstart [n+1] i32 | scan [32] i32 | row and
    column bitmaps [n, ceil(n/32)] u32 each."""
    return 16 + 20 * n + 4 * (n + 1) + 128 + 8 * n * -(-n // 32)


def _slots(n: int, used: int):
    """(edge slots, shared bytes) beside ``used`` bytes: the rest of two
    CTAs' share of an SM, or of one block's when ``used`` passes it."""
    budget = SMEM_TWO_PER_SM if used <= SMEM_TWO_PER_SM else MAX_SMEM
    cap = max(0, min(n * n, (budget - used) // EDGE_SLOT_BYTES))
    return cap, used + EDGE_SLOT_BYTES * cap


def _cluster(ctas: int) -> int:
    """Clusters of two CTAs of a subgraph where it has an even count: a
    cluster of four keeps 8 of the 132 SMs idle (124 take clusters of 4)."""
    return 2 if ctas % 2 == 0 else 1


def scratch_bytes(grid: int, n: int, edge_cap: int) -> int:
    """The scratch buffer of a launch: N^2 slots per CTA when a subgraph
    could have more edges than ``edge_cap``, else none."""
    return grid * n * n * EDGE_SLOT_BYTES if edge_cap < n * n else 0


def launch_dims(b: int, n: int, h: int, dh: int) -> GatLaunch:
    """Launch shapes for B subgraphs of N nodes, H heads of width dh.

    Forward: one CTA per (subgraph, head, dh slice); the split is the
    smallest divisor of dh/4 whose slice of v and MIN_SMEM_EDGES slots fit
    two CTAs an SM (else one).  Backward: one CTA per (subgraph,
    head); g's head slice is staged when it and MIN_SMEM_EDGES slots fit
    two CTAs an SM.  The rest of that budget (or of the whole block's,
    when the structure alone passes it) holds edge slots; a CTA whose
    subgraph has more edges uses its N^2 slots of the scratch buffer.
    Pairs of a subgraph's CTAs form clusters that share its bitmap."""
    quads = max(dh // 4, 1)
    splits = [c for c in range(1, quads + 1) if quads % c == 0]
    few = EDGE_SLOT_BYTES * min(n * n, MIN_SMEM_EDGES)
    split = next((c for budget in (SMEM_TWO_PER_SM, MAX_SMEM) for c in splits
                  if _fwd_base(n) + 4 * n * (dh // c) + few <= budget), splits[-1])
    fwd_cap, fwd_smem = _slots(n, _fwd_base(n) + 4 * n * (dh // split))
    g_bytes = 4 * n * dh
    staged = _bwd_base(n) + g_bytes + few <= SMEM_TWO_PER_SM
    bwd_cap, bwd_smem = _slots(n, _bwd_base(n) + (g_bytes if staged else 0))
    return GatLaunch(b * h * split, _cluster(h * split), split, fwd_cap, fwd_smem,
                     b * h, _cluster(h), staged, bwd_cap, bwd_smem,
                     1 if dh <= 128 else 2, THREADS)


def _levels(bf16: bool, bf16_scores: bool) -> int:
    """The kernels' level: 0 f32, 1 bf16, 2 bf16 + bf16_scores."""
    if bf16_scores and not bf16:
        raise ValueError("gat_attention: bf16_scores requires bf16")
    return int(bf16) + int(bf16_scores)


def _scores(a_s, a_n, adj_norm, adj_struct, bf16_scores=False):
    """Head-major (e [B, H, N, N], clipped denominator [B, H, N, 1]): the
    shared score math of both directions (``pallas_gat.py:_scores``);
    ``bf16_scores`` rounds S - rm and its exp to bf16."""
    s = a_s[..., :, None] + a_n[..., None, :]
    s_m = torch.where(adj_struct[:, None] > 0, s, float("-inf"))
    rm = s_m.amax(-1, keepdim=True)
    rm = torch.where(torch.isfinite(rm), rm, 0.0)
    if bf16_scores:
        e = round_bf16(torch.exp(round_bf16(s_m - rm))) * adj_norm[:, None]
    else:
        e = torch.exp(s_m - rm) * adj_norm[:, None]
    return e, torch.clamp(e.sum(-1, keepdim=True), min=1e-10)


def gat_attention_plain(att_self, att_neigh, values, adj_norm, adj_struct,
                        bf16=False, bf16_scores=False):
    """Plain PyTorch version of the forward (differentiable by autograd,
    which does not round as the levels' backward does).

    att_self, att_neigh [B, H, N]; values [B, N, H, dh]; adj_norm,
    adj_struct [B, N, N] -> [B, N, H, dh] f32."""
    _levels(bf16, bf16_scores)
    e, dn = _scores(att_self, att_neigh, adj_norm, adj_struct, bf16_scores)
    v = values.float().permute(0, 2, 1, 3)
    if bf16:
        e, v = round_bf16(e), round_bf16(v)
    out = torch.matmul(e, v) / dn
    return out.permute(0, 2, 1, 3)


def gat_attention_bwd_plain(att_self, att_neigh, values, adj_norm, adj_struct,
                            out, g, bf16=False, bf16_scores=False):
    """Plain PyTorch version of the backward (``pallas_gat.py:_bwd_kernel``):
    P = e / D, dv = P^T g, ds = P * (g v^T - rowsum(g * out)),
    d att_self = rowsum(ds), d att_neigh = colsum(ds); ``bf16`` rounds the
    operands of P^T g and g v^T.  ``out`` and ``g`` are node-major like
    ``values``.  Returns (das, dan [B, H, N], dv [B, N, H, dh] in the
    values' dtype)."""
    _levels(bf16, bf16_scores)
    e, dn = _scores(att_self, att_neigh, adj_norm, adj_struct, bf16_scores)
    p = e / dn
    v, gh, oh = (t.float().permute(0, 2, 1, 3) for t in (values, g, out))
    pd, gd, vd = (round_bf16(t) for t in (p, gh, v)) if bf16 else (p, gh, v)
    dv = torch.matmul(pd.transpose(-1, -2), gd)
    gv = torch.matmul(gd, vd.transpose(-1, -2))
    ds = p * (gv - (gh * oh).sum(-1, keepdim=True))
    return ds.sum(-1), ds.sum(-2), dv.permute(0, 2, 1, 3).to(values.dtype)


# the kernel library the wrappers launch from; chip_smoke.py switches it
# to "gat_attention_clocks" (the same kernels with per-phase clocks)
LIBRARY = "gat_attention"


def _lib_fn(name: str, n_ptr: int, n_int: int, stream: bool = True):
    from shadow_gnn_torch.ops.build import load
    fn = getattr(load(LIBRARY), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p] * stream)
    return fn


def check_limits(b: int, n: int, h: int, dh: int):
    """Raise unless the kernels take B subgraphs of N nodes, H heads of
    width dh: dh <= 256 and a multiple of 4 (float4 rows), the
    backward's bitmaps and lists in shared memory (N <= MAX_N)."""
    d = launch_dims(b, n, h, dh)
    if (n > MAX_N or dh > MAX_DH or dh % 4 or d.fwd_grid >= 2**31
            or max(d.fwd_smem, d.bwd_smem) > MAX_SMEM):
        raise ValueError(f"gat_attention: N={n}, H={h}, dh={dh}, B={b} beyond "
                         f"the kernels' limits (dh <= {MAX_DH} and a multiple of "
                         f"4, shared memory {max(d.fwd_smem, d.bwd_smem)} <= "
                         f"{MAX_SMEM} bytes: N <= {MAX_N})")


def occupancy(b: int, n: int, h: int, dh: int):
    """CTAs of (the forward, the backward) one SM holds at their launch
    shapes for B subgraphs of N nodes, H heads of width dh (on the card)."""
    d = launch_dims(b, n, h, dh)
    fn = _lib_fn("gat_attention_occupancy", 0, 3, stream=False)
    return (fn(0, d.threads, d.fwd_smem), fn(1, d.threads, d.bwd_smem))


def _check_cuda(args):
    """Device, type and shapes of a kernel call on (att_self, att_neigh,
    values, adj_norm, adj_struct, [out, g]), the values already widened
    to f32; returns (B, N, H, dh)."""
    b, h, n = args[0].shape
    dh = args[2].shape[-1]
    want = [(b, h, n)] * 2 + [(b, n, h, dh)] + [(b, n, n)] * 2 + [(b, n, h, dh)] * 2
    if any(tuple(t.shape) != w for t, w in zip(args, want)):
        raise ValueError("gat_attention: shapes " + ", ".join(
            str(tuple(t.shape)) for t in args) + " do not match (att [B, H, N], "
            "values [B, N, H, dh], blocks [B, N, N])")
    dev = args[0].device
    if any(t.device != dev for t in args) or dev.type != "cuda":
        raise ValueError("gat_attention: all tensors must be on one CUDA device "
                         "(or all on the CPU); got "
                         + ", ".join(str(t.device) for t in args))
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError("gat_attention: the kernels take float32 tensors")
    check_limits(b, n, h, dh)
    return b, n, h, dh


def _scratch(grid: int, n: int, edge_cap: int, device):
    """The edge slots of the CTAs whose subgraph outgrows shared memory."""
    nbytes = scratch_bytes(grid, n, edge_cap)
    return torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(fn, level: int):
    if level:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _forward(a_s, a_n, v, adj_norm, adj_struct, bf16=False, bf16_scores=False):
    """B2 (B2b at the bf16 levels) on CUDA tensors, the plain version on
    CPU tensors."""
    level = _levels(bf16, bf16_scores)
    args = (a_s, a_n, v, adj_norm, adj_struct)
    if all(t.device.type == "cpu" for t in args):
        return gat_attention_plain(*args, bf16, bf16_scores)
    args = tuple(t.contiguous() for t in (a_s, a_n, v.float(), adj_norm, adj_struct))
    b, n, h, dh = _check_cuda(args)
    out = torch.empty_like(args[2])
    if out.numel() == 0:
        return out
    d = launch_dims(b, n, h, dh)
    scratch = _scratch(d.fwd_grid, n, d.fwd_edge_cap, out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib_fn("gat_attention_forward", 7, 11)(
            *(t.data_ptr() for t in args), out.data_ptr(), _ptr(scratch), n, h, dh,
            d.split, d.fwd_edge_cap, d.chunks, d.fwd_grid, d.fwd_cluster, d.threads,
            d.fwd_smem, level, stream)
    if rc != 0:
        raise RuntimeError(f"gat_attention forward kernel launch failed: CUDA error {rc}")
    _count(gat_attention, level)
    return out


def gat_attention_bwd(att_self, att_neigh, values, adj_norm, adj_struct, out, g,
                      bf16=False, bf16_scores=False):
    """The backward of :func:`gat_attention`: (das, dan [B, H, N],
    dv [B, N, H, dh] in the values' dtype).  B3 (B3b at the bf16 levels)
    on CUDA tensors, one kernel launch, counted in
    ``gat_attention_bwd.launches`` (``launches_bf16``).  The plain
    version on CPU tensors."""
    level = _levels(bf16, bf16_scores)
    args = (att_self, att_neigh, values, adj_norm, adj_struct, out, g)
    if all(t.device.type == "cpu" for t in args):
        return gat_attention_bwd_plain(*args, bf16, bf16_scores)
    args = tuple(t.contiguous() for t in (att_self, att_neigh, values.float(),
                                          adj_norm, adj_struct, out, g.float()))
    b, n, h, dh = _check_cuda(args)
    das = torch.empty_like(args[0])
    dan = torch.empty_like(args[0])
    dv = torch.empty_like(args[2])
    if dv.numel() == 0:
        return das.zero_(), dan.zero_(), dv.to(values.dtype)
    d = launch_dims(b, n, h, dh)
    scratch = _scratch(d.bwd_grid, n, d.bwd_edge_cap, dv.device)
    with torch.cuda.device(dv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib_fn("gat_attention_backward", 11, 11)(
            *(t.data_ptr() for t in args), das.data_ptr(), dan.data_ptr(),
            dv.data_ptr(), _ptr(scratch), n, h, dh, int(d.g_staged), d.bwd_edge_cap,
            d.chunks, d.bwd_grid, d.bwd_cluster, d.threads, d.bwd_smem, level, stream)
    if rc != 0:
        raise RuntimeError(f"gat_attention backward kernel launch failed: CUDA error {rc}")
    _count(gat_attention_bwd, level)
    return das, dan, dv.to(values.dtype)


class _GatAttention(torch.autograd.Function):
    """B2 forward, B3 backward (``gat_attention_hm``'s custom VJP), at the
    level given.  The adjacency blocks are data: they get no gradient."""

    @staticmethod
    def forward(ctx, a_s, a_n, v, adj_norm, adj_struct, bf16, bf16_scores):
        out = _forward(a_s, a_n, v, adj_norm, adj_struct, bf16, bf16_scores)
        ctx.save_for_backward(a_s, a_n, v, adj_norm, adj_struct, out)
        ctx.levels = (bf16, bf16_scores)
        return out

    @staticmethod
    def backward(ctx, g):
        das, dan, dv = gat_attention_bwd(*ctx.saved_tensors, g, *ctx.levels)
        return das, dan, dv, None, None, None, None


def gat_attention(att_self: torch.Tensor, att_neigh: torch.Tensor,
                  values: torch.Tensor, adj_norm: torch.Tensor,
                  adj_struct: torch.Tensor, bf16: bool = False,
                  bf16_scores: bool = False) -> torch.Tensor:
    """Masked-softmax attention aggregation.

    att_self, att_neigh [B, H, N] f32 per-node score terms; values
    [B, N, H, dh] f32 or bf16; adj_norm [B, N, N] f32 (the structural
    block with dropped edges zeroed); adj_struct [B, N, N] f32 0/1.
    Returns the aggregated [B, N, H, dh] f32 block.  Differentiable in
    att_self, att_neigh and values.  ``bf16`` / ``bf16_scores`` pick the
    level (module docstring).  ``gat_attention.launches`` and
    ``gat_attention.launches_bf16`` count the forward kernel's launches
    at the f32 and the bf16 levels."""
    return _GatAttention.apply(att_self, att_neigh, values, adj_norm, adj_struct,
                               bool(bf16), bool(bf16_scores))


gat_attention.launches = gat_attention.launches_bf16 = 0
gat_attention_bwd.launches = gat_attention_bwd.launches_bf16 = 0
