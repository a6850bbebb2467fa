"""Fused LayerNorm and RMSNorm: the kernels' wrappers and their plain
versions.

Replace the TPU kernels ``layernorm`` (``_layernorm_kernel``) and
``rmsnorm`` (``_rmsnorm_kernel``) in the reference's ``kernels/rmsnorm.py``;
the module keeps that name.  The plain versions are ``ref.layernorm_ref``
and ``ref.rmsnorm_ref``.

LayerNorm is Triton: a row reduction followed by an elementwise
normalise, no tensor-core work and no state across blocks.  One program
per row; the whole row (BLOCK_D = next power of two >= d) sits in
registers, so x is read once and y written once; two-pass moments in fp32
(mean, then mean((x-μ)²)), optional bias, output in x's dtype.  At ESM-2's
serving shape (rows = 32·1024, d = 1280, bf16) it moves 168 MB: 50 µs on
an H100 SXM (3.35 TB/s), and Triton's launcher (~60 µs of host time a
call) hides under that.

RMSNorm is CUDA C++ (``csrc/rmsnorm.cu``, bound through ctypes like the
port's other CUDA kernels).  Triton no longer serves it: at Qwen2-7B's
decode shape (32, 3584) the device work is ~1.6 µs and Triton's Python
launcher costs ~40× that, 57 times a decode step.  The kernel holds a row
in registers in 16-byte vectors (one block per row, sized from d), sums
the squares in fp32 through warp shuffles and writes y once; its source
note gives the design and the bound (8.8 µs at the (2048, 3584) prefill
shape, 0.14 µs at the decode shape).  The wrapper keeps the host path
short: the C function and its argument types are set once, the checks are
attribute reads, the stream is read raw (no ``Stream`` object a call),
and only the output is allocated.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  ``layernorm.launches`` and ``rmsnorm.launches`` count kernel
launches.  ``triton`` is imported inside the launching function, so this
module imports on a machine without it.  ``layernorm_ad`` and
``rmsnorm_ad`` are the differentiable norms: the kernel forward and a
plain PyTorch backward (see ``_LayerNorm``, ``_RMSNorm``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
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


def _check_layernorm_args(x: torch.Tensor, params) -> None:
    d = x.shape[-1]
    if x.device.type != "cuda" or any(p.device != x.device for p in params):
        raise ValueError(f"layernorm: x and its weights must share one CUDA device; got "
                         f"{x.device}, {[str(p.device) for p in params]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"layernorm kernel takes {_DTYPES}; got {x.dtype}")
    if x.stride(-1) != 1 or any(p.shape != (d,) or not p.is_contiguous() for p in params):
        raise ValueError(f"layernorm: x needs a contiguous last dim and its weights contiguous "
                         f"shape ({d},); got x strides {x.stride()}, "
                         f"{[tuple(p.shape) for p in params]}")


def layernorm(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last dim of x (any leading shape)."""
    if x.device.type == "cpu":
        return layernorm_ref(x, w, b, eps)
    d = x.shape[-1]
    _check_layernorm_args(x, (w,) if b is None else (w, b))
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


# torch dtype -> the kernel's dtype code
_RMS_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_WIDTH = 1 << 14     # csrc/rmsnorm.cu: 1024 threads of two 8-element vectors
_rms_fn = None


def _rmsnorm_fn():
    """The kernel's C entry point, its argument types set once."""
    global _rms_fn
    if _rms_fn is None:
        lib = _build.load("rmsnorm")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn = lib.rmsnorm
        fn.argtypes = [p, p, p, i, i, i64, i, ctypes.c_float, p]
        fn.restype = i
        if lib.rmsnorm_max_width() != _MAX_WIDTH:
            raise RuntimeError(f"rmsnorm kernel takes widths up to {lib.rmsnorm_max_width()}, "
                               f"the wrapper checks against {_MAX_WIDTH}")
        _rms_fn = fn
    return _rms_fn


def check_rmsnorm_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the RMSNorm kernel does not take (any device): fp32,
    bf16 or fp16 x and w on one device, a contiguous last dim, w contiguous
    of shape (d,), d a multiple of 8 up to 16384, and 16-byte
    aligned rows and weights."""
    d = x.shape[-1]
    if x.device != w.device:
        raise ValueError(f"rmsnorm: x and w must share one device; got {x.device}, {w.device}")
    if x.dtype not in _RMS_CODES or w.dtype not in _RMS_CODES:
        raise TypeError(f"rmsnorm kernel takes {tuple(_RMS_CODES)}; got {x.dtype}, {w.dtype}")
    if x.stride(-1) != 1 or w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"rmsnorm: x needs a contiguous last dim and w contiguous shape "
                         f"({d},); got x strides {x.stride()}, w {tuple(w.shape)}")
    if d % 8 or not 0 < d <= _MAX_WIDTH:
        raise ValueError(f"rmsnorm kernel takes widths that are multiples of 8 up to "
                         f"{_MAX_WIDTH}; got {d}")
    rows_aligned = all(s * x.element_size() % 16 == 0
                       for s, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1)
    if x.data_ptr() % 16 or w.data_ptr() % 16 or not rows_aligned:
        raise ValueError(f"rmsnorm kernel reads 16-byte vectors: x and w must start 16-byte "
                         f"aligned and x's row strides {x.stride()[:-1]} be multiples of "
                         f"16 bytes")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of x (any leading shape); ``rmsnorm_ad``
    is its differentiable form.  On the card the common case costs a few
    attribute reads, one allocation and the launch: the full checks run
    only to name what the kernel does not take."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rmsnorm_ref(x, w, eps)
        raise ValueError(f"rmsnorm: x must lie on the CPU or a CUDA device; got {x.device}")
    fn = _rms_fn or _rmsnorm_fn()
    d = x.shape[-1]
    if x.is_contiguous():    # rows of d elements: 16-byte aligned when x's start is
        rs, y = d, torch.empty_like(x)
    else:
        shape = x.shape
        x = x.reshape(-1, d)     # a view where the leading dims collapse, else a copy
        rs = x.stride(0)
        if x.stride(1) != 1 or rs * x.element_size() % 16:
            check_rmsnorm_args(x, w)
        y = x.new_empty(shape)
    xc, wc = _RMS_CODES.get(x.dtype), _RMS_CODES.get(w.dtype)
    xp, wp, dev = x.data_ptr(), w.data_ptr(), x.get_device()
    if (xc is None or wc is None or w.shape != (d,) or w.stride(0) != 1 or d % 8
            or not 0 < d <= _MAX_WIDTH or (xp | wp) % 16 or w.get_device() != dev):
        check_rmsnorm_args(x, w)
    rows = x.numel() // d
    if rows:
        err = fn(xp, wp, y.data_ptr(), rows, d, rs, xc | wc << 2, eps,
                 torch._C._cuda_getCurrentRawStream(dev))
        if err:
            raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
        rmsnorm.launches += 1
    return y


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
