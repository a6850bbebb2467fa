"""Flash-decoding: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``flash_decode`` (``_fd_kernel``) of the reference
package: one query token per row against a dense KV cache with a per-row
valid length.  The kernel is ``csrc/flash_decode.cu`` (CUDA C++ for sm_90a:
the cache split into fixed 256-key chunks, one block per (row, kv head,
chunk); its warps stream 16-key K and V stages through cp.async rings and
run QKᵀ and PV on the tensor cores with an online softmax, and the fp32
partials are combined in split order by a second kernel; its source note
gives the design and the bound).  The plain version is
``ref.decode_attention_ref``.

The wrapper takes the reference's layout — q (B, 1, H, D), k/v (B, T, Hkv,
D), lengths (B,) — through strides, so a layer's slice of the stacked
serving cache goes in without a copy.  A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises.
``flash_decode.launches`` counts kernel launches (the split pass and the
combine pass of one call count one).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

_MAX_GROUP = 16
_MAX_GRID_YZ = 65535


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor) -> None:
    """Raise on what the kernel does not take (any device)."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,1,H,D) and k, v (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv or H // Hkv > _MAX_GROUP:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         f"(GQA group at most {_MAX_GROUP})")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(f"lengths must be contiguous int32 ({B},); got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode takes bfloat16 operands on the card; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128):
        raise ValueError(f"flash_decode supports head_dim 64 or 128, got {D}")
    if B > _MAX_GRID_YZ or Hkv > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or kv heads {Hkv} exceed the kernel's grid limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte vector loads of K/V rows: contiguous head dim, 8-element strides
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous and every other "
                             f"stride a multiple of 8 elements (16 bytes); strides {t.stride()}")


def _lib():
    lib = _build.load("flash_decode")
    if lib.flash_decode.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.flash_decode.argtypes = [p] * 8 + [i] * 5 + [i64] * 10 + [ctypes.c_float, p]
        lib.flash_decode.restype = i
        lib.flash_decode_splits.argtypes = [i]
        lib.flash_decode_splits.restype = i
    return lib


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                 *, softcap: float = 0.0) -> torch.Tensor:
    """(B, 1, H, D) in q.dtype: each row's query over its first
    ``lengths[b]`` cache rows; a row of length 0 gives zeros."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, softcap=softcap)
    _build.check_device("flash_decode", q, k, v, lengths)
    check_args(q, k, v, lengths)
    B, _, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    lib = _lib()
    splits = lib.flash_decode_splits(T)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    n = B * H * splits
    part = torch.empty((n * (D + 2),), dtype=torch.float32, device=q.device)
    base = part.data_ptr()       # m (n), l (n), acc (n, D), fp32
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        base, base + 4 * n, base + 8 * n,
        B, T, H, Hkv, D,
        q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3], out.stride(0), out.stride(2),
        float(softcap), torch._C._cuda_getCurrentRawStream(q.device.index),
    )
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
