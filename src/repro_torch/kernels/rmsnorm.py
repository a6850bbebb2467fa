"""Fused LayerNorm and RMSNorm: the kernels' wrappers and their plain
versions.

Replace the TPU kernels ``layernorm`` (``_layernorm_kernel``) and
``rmsnorm`` (``_rmsnorm_kernel``) in the reference's ``kernels/rmsnorm.py``;
the module keeps that name.  The plain versions are ``ref.layernorm_ref``
and ``ref.rmsnorm_ref``.

Both norms are CUDA C++ (``csrc/layernorm.cu``, ``csrc/rmsnorm.cu``), bound
through ctypes like the port's other CUDA kernels.  At the decode shapes
(32 rows) a norm's device work is 1.6-2.5 µs, and Triton's Python launcher,
which served both at first, cost 54-76 µs a call; a decode step runs a norm
19-73 times.  Each kernel holds a row in registers in 16-byte vectors (a
block a row at a time, sized from d), sums its moments in fp32 through
warp shuffles and writes the output once; the source notes give the design
and the bounds.  The wrappers keep the host path short: the C functions and
their argument types are set once, the checks are attribute reads, the
stream is read raw (no ``Stream`` object a call), and only the outputs are
allocated.

LayerNorm's gradient is a kernel of the port's own, ``layernorm_bwd``
(same source; the reference pairs its Pallas forward with an XLA
backward): dx a row at a time and dw/db summed over the rows in a fixed
order, through per-block partials in a workspace and a second launch, no
atomics.  ``ref.layernorm_bwd_sched_ref`` follows its schedule.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  ``layernorm.launches``, ``layernorm_bwd.launches`` and
``rmsnorm.launches`` count the wrappers' launches.  ``layernorm_ad`` and
``rmsnorm_ad`` are the differentiable norms: LayerNorm pairs its two
kernels; RMSNorm pairs its kernel with the reference's backward formulas
in plain PyTorch (see ``_LayerNorm``, ``_RMSNorm``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (layernorm_bwd_ref, layernorm_ref, rmsnorm_bwd_ref,
                                     rmsnorm_ref)

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


_LN_MAX_WIDTH = 1 << 14      # csrc/layernorm.cu: the forward's widest row
_LN_BWD_MAX_WIDTH = 1 << 13  # and the backward's (512 threads of two vectors)
_NO_BIAS = 3                 # the kernel's dtype code for "no bias"
_ln_fns = None


def _layernorm_fns():
    """The kernels' C entry points (forward, backward), argument types set
    once, and the backward's workspace in fp32 elements (any rows and d)."""
    global _ln_fns
    if _ln_fns is None:
        lib = _build.load("layernorm")
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        fwd, bwd = lib.layernorm, lib.layernorm_bwd
        fwd.argtypes = [p, p, p, p, i, i, i64, i, f, p]
        bwd.argtypes = [p, p, p, p, p, p, p, i64, i, i, i64, i64, i, f, p]
        fwd.restype = bwd.restype = i
        widths = (lib.layernorm_max_width(), lib.layernorm_bwd_max_width())
        if widths != (_LN_MAX_WIDTH, _LN_BWD_MAX_WIDTH):
            raise RuntimeError(f"layernorm kernels take widths up to {widths}, the wrapper "
                               f"checks against {(_LN_MAX_WIDTH, _LN_BWD_MAX_WIDTH)}")
        lib.layernorm_bwd_workspace.restype = i64
        _ln_fns = (fwd, bwd, lib.layernorm_bwd_workspace())
    return _ln_fns


def check_layernorm_args(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                         dy: Optional[torch.Tensor] = None) -> None:
    """Raise on what the LayerNorm kernels do not take (any device): fp32,
    bf16 or fp16 x, w and b on one device, a contiguous last dim, w and b
    contiguous of shape (d,), d a multiple of 8 up to 16384 (8192 for the
    backward, when ``dy`` is given, which must then be x's dtype and shape),
    and 16-byte aligned rows and weights."""
    d = x.shape[-1]
    rows = [x] if dy is None else [x, dy]
    params = [w] if b is None else [w, b]
    if any(t.device != x.device for t in rows + params):
        raise ValueError(f"layernorm: x and its weights must share one device; got "
                         f"{[str(t.device) for t in rows + params]}")
    if any(t.dtype not in _RMS_CODES for t in rows + params):
        raise TypeError(f"layernorm kernel takes {tuple(_RMS_CODES)}; got "
                        f"{[t.dtype for t in rows + params]}")
    if dy is not None and (dy.dtype != x.dtype or dy.shape != x.shape):
        raise ValueError(f"layernorm backward: dy must have x's dtype and shape; got "
                         f"{dy.dtype} {tuple(dy.shape)}, x {x.dtype} {tuple(x.shape)}")
    if any(t.stride(-1) != 1 for t in rows) or any(p.shape != (d,) or not p.is_contiguous()
                                                   for p in params):
        raise ValueError(f"layernorm: x needs a contiguous last dim and its weights contiguous "
                         f"shape ({d},); got x strides {x.stride()}, "
                         f"{[tuple(p.shape) for p in params]}")
    widest = _LN_MAX_WIDTH if dy is None else _LN_BWD_MAX_WIDTH
    if d % 8 or not 0 < d <= widest:
        raise ValueError(f"layernorm {'kernel' if dy is None else 'backward kernel'} takes "
                         f"widths that are multiples of 8 up to {widest}; got {d}")
    rows_aligned = all(s * t.element_size() % 16 == 0 for t in rows
                       for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)
    if any(t.data_ptr() % 16 for t in rows + params) or not rows_aligned:
        raise ValueError(f"layernorm kernel reads 16-byte vectors: x and its weights must start "
                         f"16-byte aligned and x's row strides {x.stride()[:-1]} be multiples "
                         f"of 16 bytes")


def _lean_params_ok(w, b, d, dev) -> bool:
    """w and b as the kernels take them, by attribute reads alone."""
    if (w.dtype not in _RMS_CODES or w.shape != (d,) or w.stride(0) != 1 or w.data_ptr() % 16
            or w.get_device() != dev):
        return False
    return b is None or (b.dtype in _RMS_CODES and b.shape == (d,) and b.stride(0) == 1
                         and not b.data_ptr() % 16 and b.get_device() == dev)


def layernorm(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last dim of x (any leading shape); ``layernorm_ad``
    is its differentiable form.  On the card the common case costs a few
    attribute reads, one allocation and the launch: the full checks run
    only to name what the kernel does not take."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layernorm_ref(x, w, b, eps)
        raise ValueError(f"layernorm: x must lie on the CPU or a CUDA device; got {x.device}")
    fwd = (_ln_fns or _layernorm_fns())[0]
    d = x.shape[-1]
    if x.is_contiguous():    # rows of d elements: 16-byte aligned when x's start is
        rs, y = d, torch.empty_like(x)
    else:
        shape = x.shape
        x = x.reshape(-1, d)     # a view where the leading dims collapse, else a copy
        rs = x.stride(0)
        if x.stride(1) != 1 or (x.shape[0] > 1 and rs * x.element_size() % 16):
            check_layernorm_args(x, w, b)
        y = x.new_empty(shape)
    xc, dev = _RMS_CODES.get(x.dtype), x.get_device()
    if xc is None or d % 8 or not 0 < d <= _LN_MAX_WIDTH or x.data_ptr() % 16 \
            or not _lean_params_ok(w, b, d, dev):
        check_layernorm_args(x, w, b)
    rows = x.numel() // d
    if rows:
        codes = xc | _RMS_CODES[w.dtype] << 2 | (_NO_BIAS if b is None else _RMS_CODES[b.dtype]) << 4
        err = fwd(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
                  rows, d, rs, codes, eps, torch._C._cuda_getCurrentRawStream(dev))
        if err:
            raise RuntimeError(f"layernorm kernel launch failed: cudaError {err}")
        layernorm.launches += 1
    return y


layernorm.launches = 0


def layernorm_bwd(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], dy: torch.Tensor,
                  eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """LayerNorm's gradient: (dx in x's dtype, dw in w's, db in b's or None
    without a bias), ``ref.layernorm_bwd_ref``'s function with the moments
    recomputed from x.  On the card: the backward kernel, then the sum of
    its per-block partials (``csrc/layernorm.cu``); a repeat is
    bit-identical and dx of a row does not depend on the other rows.  A
    dy whose rows the kernel cannot read as they lie (an expanded gradient,
    a view that starts inside a 16-byte vector) is copied first."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layernorm_bwd_ref(x, w, b, dy, eps)
        raise ValueError(f"layernorm_bwd: x must lie on the CPU or a CUDA device; got {x.device}")
    _, bwd, ws_elems = _ln_fns or _layernorm_fns()
    d = x.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        check_layernorm_args(x, w, b, dy)
    if x.is_contiguous() and dy.is_contiguous():     # rows of d elements
        x2, dy2, rows = x, dy, x.numel() // max(d, 1)
        x_rs = dy_rs = d
    else:
        x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
        rows = x2.shape[0]
        if dy2.stride(1) != 1 or (rows > 1 and dy2.stride(0) * dy2.element_size() % 16):
            dy2 = dy2.contiguous()                   # e.g. an expanded gradient
        x_rs, dy_rs = x2.stride(0), dy2.stride(0)
        if x2.stride(1) != 1 or (rows > 1 and x_rs * x.element_size() % 16):
            check_layernorm_args(x2, w, b, dy2)
    if dy2.data_ptr() % 16:                          # a view that starts inside a vector
        dy2, dy_rs = dy2.reshape(-1, d).clone(), d
    xc, dev = _RMS_CODES.get(x.dtype), x.get_device()
    if (xc is None or x2.data_ptr() % 16 or dy2.get_device() != dev or d % 8
            or not 0 < d <= _LN_BWD_MAX_WIDTH or not _lean_params_ok(w, b, d, dev)):
        check_layernorm_args(x2, w, b, dy2)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dw = torch.empty_like(w)
    db = None if b is None else torch.empty_like(b)
    if not rows:
        return dx, dw.zero_(), None if db is None else db.zero_()
    ws = _build.scratch(dev, ws_elems)
    codes = xc | _RMS_CODES[w.dtype] << 2 | (_NO_BIAS if b is None else _RMS_CODES[b.dtype]) << 4
    err = bwd(x2.data_ptr(), dy2.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
              None if db is None else db.data_ptr(), ws.data_ptr(), ws.numel(), rows, d, x_rs,
              dy_rs, codes, eps, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"layernorm backward kernel launch failed: cudaError {err}")
    layernorm_bwd.launches += 1
    return dx, dw, db


layernorm_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):
    """Forward and backward: the kernels (``layernorm``, ``layernorm_bwd``)
    or, with ``plain``, their plain versions; the backward recomputes the
    moments from x, so the forward saves only its inputs."""

    @staticmethod
    def forward(ctx, x, w, b, eps, plain):
        ctx.save_for_backward(x, w, b)
        ctx.eps, ctx.plain = eps, plain
        return (layernorm_ref if plain else layernorm)(x, w, b, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dx, dw, db = (layernorm_bwd_ref if ctx.plain else layernorm_bwd)(x, w, b, dy, ctx.eps)
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
