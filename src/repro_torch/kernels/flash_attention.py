"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``flash_attention_fwd`` (``_fa_kernel``) of the
reference package.  The kernel is ``csrc/flash_attention_fwd.cu`` (CUDA C++
for sm_90a, mma.sync tensor cores, fp32 online softmax); its source note
gives the design and the bound.  The plain version is
``ref.attention_ref``.

``flash_attention_fwd`` takes the reference's layout — q (B, S, H, D), k/v
(B, T, Hkv, D) — and returns ``(out, lse)`` with the reference's shapes.
A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  ``flash_attention_fwd.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

NAME = "flash_attention_fwd"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}
_MAX_GRID_Y = 65535


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take (any device)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd kernel takes bfloat16 or float16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention_fwd kernel supports head_dim 64 or 128, got {D}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"batch*heads {B * H} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte vector loads: contiguous head dim, 8-element-aligned rows
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous and every other "
                             f"stride a multiple of 8 elements (16 bytes); strides {t.stride()}")


def _kernel():
    fn = _build.load(NAME).flash_attention_fwd
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i] + [i64] * 12 + [i, i, ctypes.c_float, i, p]
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
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_fwd: q, k, v must share one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    check_args(q, k, v)
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    err = _kernel()(
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


flash_attention_fwd.launches = 0
