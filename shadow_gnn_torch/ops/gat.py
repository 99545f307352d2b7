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

Counterpart of ``shadow_gnn_tpu/ops/pallas_gat.py`` (``gat_attention``
with its custom VJP, node-major values).  Its ``bf16`` and
``bf16_scores`` levels are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

ROWS_PER_BLOCK = 8      # output rows per block of the rows kernels
COLS_PER_BLOCK = 32     # columns per block of the backward's column kernel
THREADS = 256           # 8 warps
MAX_DH = 256            # each lane keeps dh / 32 values in registers
MAX_SMEM = 232_448      # dynamic shared memory one block may use on sm_90


def launch_dims(b: int, n: int):
    """Launch shapes of both kernels for B subgraphs of N nodes:
    (rows grid, threads, rows shared bytes, row tiles, column grid,
    column shared bytes, column tiles).

    Rows kernels: one block per (subgraph, tile of ROWS_PER_BLOCK rows);
    shared memory holds each tile row's adjn values (f32) and structural
    columns (u16), one score row per warp (f32) and the row counts.
    Column kernel: one block per (subgraph, tile of 32 columns); shared
    memory holds a bitmap of each column."""
    r, warps = ROWS_PER_BLOCK, THREADS // 32
    tiles = -(-n // r)
    smem = 4 * r * n + 4 * warps * n + 4 * r + 2 * r * n
    col_tiles = -(-n // COLS_PER_BLOCK)
    col_smem = 4 * COLS_PER_BLOCK * -(-n // 32)
    return b * tiles, THREADS, smem, tiles, b * col_tiles, col_smem, col_tiles


def _scores(a_s, a_n, adj_norm, adj_struct):
    """Head-major (e [B, H, N, N], clipped denominator [B, H, N, 1]): the
    shared score math of both directions (``pallas_gat.py:_scores``)."""
    s = a_s[..., :, None] + a_n[..., None, :]
    s_m = torch.where(adj_struct[:, None] > 0, s, float("-inf"))
    rm = s_m.amax(-1, keepdim=True)
    rm = torch.where(torch.isfinite(rm), rm, 0.0)
    e = torch.exp(s_m - rm) * adj_norm[:, None]
    return e, torch.clamp(e.sum(-1, keepdim=True), min=1e-10)


def gat_attention_plain(att_self, att_neigh, values, adj_norm, adj_struct):
    """Plain PyTorch version of the forward (differentiable by autograd).

    att_self, att_neigh [B, H, N]; values [B, N, H, dh]; adj_norm,
    adj_struct [B, N, N] -> [B, N, H, dh] f32."""
    e, dn = _scores(att_self, att_neigh, adj_norm, adj_struct)
    out = torch.matmul(e, values.permute(0, 2, 1, 3)) / dn
    return out.permute(0, 2, 1, 3)


def gat_attention_bwd_plain(att_self, att_neigh, values, adj_norm, adj_struct,
                            out, g):
    """Plain PyTorch version of the backward (``pallas_gat.py:_bwd_kernel``):
    P = e / D, dv = P^T g, ds = P * (g v^T - rowsum(g * out)),
    d att_self = rowsum(ds), d att_neigh = colsum(ds).  ``out`` and ``g``
    are node-major like ``values``.  Returns (das, dan [B, H, N],
    dv [B, N, H, dh])."""
    e, dn = _scores(att_self, att_neigh, adj_norm, adj_struct)
    p = e / dn
    v, gh, oh = (t.permute(0, 2, 1, 3) for t in (values, g, out))
    dv = torch.matmul(p.transpose(-1, -2), gh)
    gv = torch.matmul(gh, v.transpose(-1, -2))
    ds = p * (gv - (gh * oh).sum(-1, keepdim=True))
    return ds.sum(-1), ds.sum(-2), dv.permute(0, 2, 1, 3)


def _lib_fn(name: str, n_ptr: int, n_int: int):
    from shadow_gnn_torch.ops.build import load
    fn = getattr(load("gat_attention"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
    return fn


def check_limits(b: int, n: int, dh: int):
    """Raise unless the kernels take B subgraphs of N nodes at head
    width dh (u16 column lists, dh / 32 values per lane, the rows
    kernels' shared memory)."""
    grid, _, smem, _, _, _, _ = launch_dims(b, n)
    if n > 65535 or dh > MAX_DH or smem > MAX_SMEM or grid >= 2**31:
        raise ValueError(f"gat_attention: N={n}, dh={dh}, B={b} beyond the "
                         f"kernels' limits (dh <= {MAX_DH}, shared memory "
                         f"{smem} <= {MAX_SMEM} bytes)")


def _check_cuda(args):
    """Device, type and shapes of a kernel call on (att_self, att_neigh,
    values, adj_norm, adj_struct, [out, g]); returns (B, N, H, dh)."""
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
    check_limits(b, n, dh)
    return b, n, h, dh


def _forward(a_s, a_n, v, adj_norm, adj_struct):
    """B2 on CUDA tensors, the plain version on CPU tensors."""
    args = (a_s, a_n, v, adj_norm, adj_struct)
    if all(t.device.type == "cpu" for t in args):
        return gat_attention_plain(*args)
    args = tuple(t.contiguous() for t in args)
    b, n, h, dh = _check_cuda(args)
    out = torch.empty_like(args[2])
    if out.numel() == 0:
        return out
    grid, threads, smem, tiles, _, _, _ = launch_dims(b, n)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib_fn("gat_attention_forward", 6, 9)(
            *(t.data_ptr() for t in args), out.data_ptr(), b, n, h, dh,
            ROWS_PER_BLOCK, tiles, grid, threads, smem, stream)
    if rc != 0:
        raise RuntimeError(f"gat_attention forward kernel launch failed: CUDA error {rc}")
    gat_attention.launches += 1
    return out


def gat_attention_bwd(att_self, att_neigh, values, adj_norm, adj_struct, out, g):
    """The backward of :func:`gat_attention`: (das, dan [B, H, N],
    dv [B, N, H, dh]).  B3 on CUDA tensors (one row-pass and one
    column-pass kernel, counted as one launch in
    ``gat_attention_bwd.launches``), the plain version on CPU tensors."""
    args = (att_self, att_neigh, values, adj_norm, adj_struct, out, g)
    if all(t.device.type == "cpu" for t in args):
        return gat_attention_bwd_plain(*args)
    args = tuple(t.contiguous() for t in args)
    b, n, h, dh = _check_cuda(args)
    das = torch.empty_like(args[0])
    dan = torch.empty_like(args[0])
    dv = torch.empty_like(args[2])
    if dv.numel() == 0:
        return das.zero_(), dan.zero_(), dv
    stats = torch.empty((3,) + tuple(args[0].shape), device=dv.device)
    grid, threads, smem, tiles, col_grid, col_smem, col_tiles = launch_dims(b, n)
    with torch.cuda.device(dv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib_fn("gat_attention_backward", 11, 12)(
            *(t.data_ptr() for t in args), das.data_ptr(), dan.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), b, n, h, dh, ROWS_PER_BLOCK, tiles,
            grid, threads, smem, col_tiles, col_grid, col_smem, stream)
    if rc != 0:
        raise RuntimeError(f"gat_attention backward kernel launch failed: CUDA error {rc}")
    gat_attention_bwd.launches += 1
    return das, dan, dv


class _GatAttention(torch.autograd.Function):
    """B2 forward, B3 backward (``gat_attention_hm``'s custom VJP).  The
    adjacency blocks are data: they get no gradient."""

    @staticmethod
    def forward(ctx, a_s, a_n, v, adj_norm, adj_struct):
        out = _forward(a_s, a_n, v, adj_norm, adj_struct)
        ctx.save_for_backward(a_s, a_n, v, adj_norm, adj_struct, out)
        return out

    @staticmethod
    def backward(ctx, g):
        das, dan, dv = gat_attention_bwd(*ctx.saved_tensors, g)
        return das, dan, dv, None, None


def gat_attention(att_self: torch.Tensor, att_neigh: torch.Tensor,
                  values: torch.Tensor, adj_norm: torch.Tensor,
                  adj_struct: torch.Tensor, bf16: bool = False,
                  bf16_scores: bool = False) -> torch.Tensor:
    """Masked-softmax attention aggregation.

    att_self, att_neigh [B, H, N] f32 per-node score terms; values
    [B, N, H, dh] f32; adj_norm [B, N, N] f32 (the structural block with
    dropped edges zeroed); adj_struct [B, N, N] f32 0/1.  Returns the
    aggregated [B, N, H, dh] f32 block.  Differentiable in att_self,
    att_neigh and values.  ``gat_attention.launches`` counts the forward
    kernel's launches."""
    if bf16 or bf16_scores:
        raise NotImplementedError("gat_attention: the bf16 and bf16_scores "
                                  "levels are not ported yet")
    return _GatAttention.apply(att_self, att_neigh, values, adj_norm, adj_struct)


gat_attention.launches = 0
gat_attention_bwd.launches = 0
