"""Flash attention: the CUDA kernels' wrappers, their plain versions, and
the differentiable op that pairs them.

Replaces the TPU kernels ``flash_attention_fwd`` (``_fa_kernel``) and
``flash_attention_bwd`` (``_fa_delta_kernel``, ``_fa_dq_kernel``,
``_fa_dkv_kernel``) of the reference package.  The kernels are
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` (CUDA
C++ for sm_90a, mma.sync tensor cores, fp32 softmax math); their source
notes give the design and the bound.  The plain versions are
``ref.attention_ref`` and ``ref.attention_bwd_ref``.

Both wrappers take the reference's layout — q (B, S, H, D), k/v (B, T,
Hkv, D), lse (B·H, S) — through strides.  A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises.
``flash_attention_fwd.launches`` and ``flash_attention_bwd.launches`` count
kernel launches; one backward call (Δ pre-pass, dQ pass, dK/dV pass) counts
one.  ``attention`` is the ``torch.autograd.Function`` that saves (q, k, v,
out, lse) in the forward and runs the backward from them, as the
reference's ``ops._attention_pallas`` custom VJP does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}
_MAX_GRID_Y = 65535


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> None:
    """Raise on what the kernels do not take (any device).  ``more`` are
    further (B, S, H, D) operands of the backward (out, dO)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"out and dO must have q's shape {tuple(q.shape)}; got "
                         f"{[tuple(t.shape) for t in more]}")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise TypeError(f"flash attention kernels take bfloat16 or float16 operands "
                        f"of one dtype; got {[str(t.dtype) for t in (q, k, v, *more)]}")
    if D not in (64, 128):
        raise ValueError(f"flash attention kernels support head_dim 64 or 128, got {D}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"batch*heads {B * H} exceeds the kernels' grid limit {_MAX_GRID_Y}")
    for name, t in zip(("q", "k", "v", "out", "dO"), (q, k, v, *more)):
        # 16-byte vector loads: contiguous head dim, 8-element-aligned rows
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous and every other "
                             f"stride a multiple of 8 elements (16 bytes); strides {t.stride()}")


def _fwd_kernel():
    fn = _build.load("flash_attention_fwd").flash_attention_fwd
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i] + [i64] * 12 + [i, i, ctypes.c_float, i, p]
        fn.restype = i
    return fn


def _bwd_kernel():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 7 + [p, i, i, ctypes.c_float, i, p]
        fn.restype = i
    return fn


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B,S,H,D) in q.dtype, lse (B·H, S) fp32)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset)
    _build.check_device("flash_attention_fwd", q, k, v)
    check_args(q, k, v)
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    err = _fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, T, H, Hkv, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), int(window), float(softcap), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the input dtypes, from the forward's (out, lse)."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset)
    _build.check_device("flash_attention_bwd", q, k, v, out, lse, do)
    check_args(q, k, v, out, do)
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if lse.shape != (B * H, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 ({B * H}, {S}); got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, T, Hkv, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, T, Hkv, D), dtype=v.dtype, device=v.device)
    delta = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, out, do, dq, dk, dv) for s in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(strides))(*strides)
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, T, H, Hkv, D, ctypes.addressof(strides),
        int(causal), int(window), float(softcap), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, plain):
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        out, lse = (attention_ref if plain else flash_attention_fwd)(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw, ctx.plain = kw, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = attention_bwd_ref if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int = 0, softcap: float = 0.0, q_offset: int = 0,
              plain: bool = False) -> torch.Tensor:
    """Differentiable attention (B,S,H,D) -> (B,S,H,D): the kernels, or with
    ``plain`` the plain versions on any device."""
    return _Attention.apply(q, k, v, causal, window, softcap, q_offset, plain)
