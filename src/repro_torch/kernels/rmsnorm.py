"""Fused LayerNorm and RMSNorm: the Triton kernels' wrappers and their
plain versions.

Replace the TPU kernels ``layernorm`` (``_layernorm_kernel``) and
``rmsnorm`` (``_rmsnorm_kernel``) in the reference's ``kernels/rmsnorm.py``;
the module keeps that name.  The plain versions are ``ref.layernorm_ref``
and ``ref.rmsnorm_ref``.

Why Triton: each op is a row reduction followed by an elementwise
normalise — no tensor-core work and no state across blocks.  Triton's
masked block loads express it fully and reach the bandwidth a CUDA kernel
would.

Design: one program per row; the whole row (BLOCK_D = next power of two
>= d) sits in registers, so x is read once and y written once.  Moments in
fp32 (LayerNorm: two-pass, mean then mean((x-μ)²) over the row held in
registers, optional bias; RMSNorm: mean(x²)), output in x's dtype.  The
TPU kernel's row blocks sized for VMEM have no counterpart: one program
per row fills the 132 SMs at the prefill shapes; at the decode shape (32
rows) the norm is a few microseconds whatever its layout.

Bound on an H100 SXM (3.35 TB/s): memory.  LayerNorm at the ESM-2 serving
shape (rows = 32·1024, d = 1280, bf16) reads and writes 2·rows·d·2 B =
168 MB: 50 µs.  RMSNorm at the Qwen2-7B prefill shape (2048, 3584) bf16
moves 29 MB: 8.8 µs; at the decode shape (32, 3584), 0.46 MB: 0.14 µs,
far below a launch.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  ``layernorm.launches`` and ``rmsnorm.launches`` count kernel
launches.  ``triton`` is imported inside the launching function, so this
module imports on a machine without it.  ``layernorm_ad`` and
``rmsnorm_ad`` are the differentiable norms: the kernel forward and a
plain PyTorch backward (see ``_LayerNorm``, ``_RMSNorm``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.ref import (layernorm_bwd_ref, layernorm_ref, rmsnorm_bwd_ref,
                                     rmsnorm_ref)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _layernorm_kernel(x_ptr, w_ptr, b_ptr, y_ptr, x_row_stride, y_row_stride, d, eps,
                          HAS_BIAS: tl.constexpr, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask, other=0.0).to(tl.float32)
        mu = tl.sum(x, axis=0) / d
        xc = tl.where(mask, x - mu, 0.0)
        var = tl.sum(xc * xc, axis=0) / d
        rstd = 1.0 / tl.sqrt(var + eps)
        y = xc * rstd * tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        if HAS_BIAS:
            y += tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * y_row_stride + cols, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, _layernorm_kernel


@functools.lru_cache(maxsize=None)
def _triton_rmsnorm_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _rmsnorm_kernel(x_ptr, w_ptr, y_ptr, x_row_stride, y_row_stride, d, eps,
                        BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask, other=0.0).to(tl.float32)
        rstd = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / d + eps)
        y = x * rstd * tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * y_row_stride + cols, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, _rmsnorm_kernel


def _check_norm_args(name: str, x: torch.Tensor, params) -> None:
    d = x.shape[-1]
    if x.device.type != "cuda" or any(p.device != x.device for p in params):
        raise ValueError(f"{name}: x and its weights must share one CUDA device; got "
                         f"{x.device}, {[str(p.device) for p in params]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes {_DTYPES}; got {x.dtype}")
    if x.stride(-1) != 1 or any(p.shape != (d,) or not p.is_contiguous() for p in params):
        raise ValueError(f"{name}: x needs a contiguous last dim and its weights contiguous "
                         f"shape ({d},); got x strides {x.stride()}, "
                         f"{[tuple(p.shape) for p in params]}")


def layernorm(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last dim of x (any leading shape)."""
    if x.device.type == "cpu":
        return layernorm_ref(x, w, b, eps)
    d = x.shape[-1]
    _check_norm_args("layernorm", x, (w,) if b is None else (w, b))
    x2 = x.reshape(-1, d)
    y = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    triton, kernel = _triton_kernel()
    block_d = triton.next_power_of_2(d)
    kernel[(x2.shape[0],)](
        x2, w, w if b is None else b, y, x2.stride(0), y.stride(0), d, eps,
        HAS_BIAS=b is not None, BLOCK_D=block_d, num_warps=min(max(block_d // 256, 1), 16),
    )
    layernorm.launches += 1
    return y.reshape(x.shape)


layernorm.launches = 0


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of x (any leading shape); ``rmsnorm_ad``
    is its differentiable form."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    _check_norm_args("rmsnorm", x, (w,))
    x2 = x.reshape(-1, d)
    y = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    triton, kernel = _triton_rmsnorm_kernel()
    block_d = triton.next_power_of_2(d)
    kernel[(x2.shape[0],)](x2, w, y, x2.stride(0), y.stride(0), d, eps,
                           BLOCK_D=block_d, num_warps=min(max(block_d // 256, 1), 16))
    rmsnorm.launches += 1
    return y.reshape(x.shape)


rmsnorm.launches = 0


class _LayerNorm(torch.autograd.Function):
    """Forward: the kernel (or the plain version); backward: the
    reference's hand-written ``_ln_bwd`` formulas (``ref.layernorm_bwd_ref``)
    with the moments recomputed from x.  The reference pairs its Pallas
    norm with that same XLA backward, outside any kernel, so the backward
    here is plain PyTorch too."""

    @staticmethod
    def forward(ctx, x, w, b, eps, plain):
        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        return (layernorm_ref if plain else layernorm)(x, w, b, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dx, dw, db = layernorm_bwd_ref(x, w, b, dy, ctx.eps)
        return dx, dw, db, None, None


def layernorm_ad(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                 eps: float = 1e-5, *, plain: bool = False) -> torch.Tensor:
    """Differentiable LayerNorm: the kernel, or with ``plain`` the plain
    version on any device."""
    return _LayerNorm.apply(x, w, b, eps, plain)


class _RMSNorm(torch.autograd.Function):
    """Forward: the kernel (or the plain version); backward: the
    reference's ``_rms_bwd`` formulas (``ref.rmsnorm_bwd_ref``) with rstd
    recomputed from x, as the reference's ``_rms_pallas_bwd`` pairs its
    Pallas norm with that XLA backward."""

    @staticmethod
    def forward(ctx, x, w, eps, plain):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return (rmsnorm_ref if plain else rmsnorm)(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_ref(x, w, dy, ctx.eps)
        return dx, dw, None, None


def rmsnorm_ad(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *,
               plain: bool = False) -> torch.Tensor:
    """Differentiable RMSNorm: the kernel, or with ``plain`` the plain
    version on any device."""
    return _RMSNorm.apply(x, w, eps, plain)
