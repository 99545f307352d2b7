"""Products at ``matmul_precision="bfloat16"`` and ``"tensorfloat32"``.

The JAX package's ``--matmul_precision bfloat16`` runs each f32 product
of the model (``jnp.dot`` / ``einsum`` at DEFAULT precision) as one
single-pass bf16 product: both operands rounded to bf16 (round to
nearest even), the products accumulated in f32, an f32 result.  Its
backward products run at the same precision, so they round their
operands too.  The port computes that function explicitly, product by
product, and never through a global torch flag:

* :func:`bf16_matmul` (the linears, the dense SAGE aggregation): on
  CUDA tensors a cuBLAS bf16 GEMM with f32 output (``torch.mm`` /
  ``torch.bmm`` with ``out_dtype=torch.float32``); on CPU tensors the
  f32 product of the rounded operands, the same function up to the
  order of the f32 sums (a product of two bf16 values is exact in f32);
* :func:`bf16_head_dot` (GAT's attention-vector contraction, a small
  reduction over dh): the f32 product of the rounded operands on every
  device.

``--matmul_precision tensorfloat32`` asks for TF32 products, which is
what the H100's tensor cores run for f32 operands: :func:`tf32_matmul`
(the linears, the dense aggregation) takes its f32 products, forward
and backward, inside :func:`tf32`, which lets cuBLAS use TF32 for the
one product and restores the process's setting after it; on the CPU
they stay f32 (as JAX's CPU products do).  GAT's attention-vector
contraction, a reduction over dh and no GEMM, stays f32.  The packed and attention kernels take their
bf16 modes at that precision, as the JAX layers do
(``ROUNDED_PRECISIONS``).  :func:`matmul` picks the product of a
precision.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "bfloat16", "tensorfloat32")
# the precisions at which the kernels run their bf16 modes
# (shadow_gnn_tpu/nn/layers.py:53, nn/model.py:152)
ROUNDED_PRECISIONS = ("bfloat16", "tensorfloat32")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even), kept in ``x``'s dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _mm(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """f32 product of two bf16 operands, [M, K] @ [K, N] or batched."""
    if a16.device.type == "cuda":
        fn = torch.mm if a16.dim() == 2 else torch.bmm
        return fn(a16, b16, out_dtype=torch.float32)
    return torch.matmul(a16.float(), b16.float())


class _Bf16Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return _mm(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        ga = _mm(g16, b16.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        gb = _mm(a16.transpose(-1, -2), g16) if ctx.needs_input_grad[1] else None
        return ga, gb


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] (or [B, M, K] @ [B, K, N]) at bf16 precision:
    f32 output; the gradients round ``g`` and the other operand."""
    return _Bf16Matmul.apply(a, b)


class _Bf16HeadDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a):
        xr, ar = round_bf16(x), round_bf16(a)
        ctx.save_for_backward(xr, ar)
        return torch.einsum("bnhd,hd->bhn", xr, ar)

    @staticmethod
    def backward(ctx, g):
        xr, ar = ctx.saved_tensors
        gr = round_bf16(g)
        gx = (torch.einsum("bhn,hd->bnhd", gr, ar)
              if ctx.needs_input_grad[0] else None)
        ga = (torch.einsum("bhn,bnhd->hd", gr, xr)
              if ctx.needs_input_grad[1] else None)
        return gx, ga


def bf16_head_dot(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """einsum("bnhd,hd->bhn", x, a) at bf16 precision (f32 x and a)."""
    return _Bf16HeadDot.apply(x, a)


@contextlib.contextmanager
def tf32():
    """Within the block cuBLAS may run f32 products on TF32 tensor cores;
    the previous setting comes back after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with tf32():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with tf32():
            ga = torch.matmul(g, b.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
            gb = torch.matmul(a.transpose(-1, -2), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] (or batched) of f32 operands, forward and
    backward on TF32 tensor cores on a card."""
    return _Tf32Matmul.apply(a, b)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b of f32 operands at ``precision`` (one of ``PRECISIONS``)."""
    if precision == "bfloat16":
        return bf16_matmul(a, b)
    if precision == "tensorfloat32":
        return tf32_matmul(a, b)
    return torch.matmul(a, b)

