"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``ssd_scan`` (``_ssd_kernel``) of the reference
package: x (B, S, H, P), dt (B, S, H) fp32, A and D (H,), B and C (B, S, G,
N) -> y (B, S, H, P) in x.dtype and the final state (B, H, P, N) fp32, the
SSD recurrence of every head in its chunked dual form, to fp32 accuracy —
the prefill of every SSM layer.  The kernel is ``csrc/ssd_scan.cu`` (CUDA
C++ for sm_90a: one block per batch row, head and 64-row slice of P walks
the chunks in order with its slice of the state in its warps' registers,
the four products on the tensor cores with the fp32 operands split into
bf16 high and low halves, the next chunk's tiles copied while this one
computes; its source note gives the design and the bound).  It takes any
S — unlike the TPU kernel, which asserts ``S % chunk == 0`` — since SSM
prompts prefill at their exact length: the last chunk's rows past S count
as x = 0, dt = 0.  The plain version is ``ref.ssd_scan_ref``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  The kernel chunks at its own 64 rows, whatever ``chunk`` says:
the function does not depend on the chunk beyond fp32 rounding, and
``chunk`` reaches only the plain version.  x, B and C may be strided views
(the SSM block slices them out of one activation) as long as their last
dim is contiguous.  Forward only: the kernel raises when asked for a
gradient (the reference's TPU kernel has no backward either; its plain
version stays differentiable).  ``ssd_scan.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

_P_TILE = 32     # rows of the state per block
_MAX_N = 128     # the block's shared-memory tiles are sized for N <= 128


def check_args(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, D: torch.Tensor) -> None:
    """Raise on what the kernel does not take (any device)."""
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"expected x (B, S, H, P) and B, C (B, S, G, N); got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if Bm.shape[:2] != (Bsz, S) or dt.shape != (Bsz, S, H) or A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"ssd_scan: dt must be {(Bsz, S, H)}, A and D ({H},), B and C "
                         f"{(Bsz, S)} + (G, N); got {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(D.shape)}, {tuple(Bm.shape)}")
    if H % G:
        raise ValueError(f"ssd_scan: {H} heads are not a whole number of {G} groups")
    if P % _P_TILE or N % 4 or not 0 < N <= _MAX_N:
        raise ValueError(f"ssd_scan takes P a multiple of {_P_TILE} and N a multiple of 4 up "
                         f"to {_MAX_N}; got P={P}, N={N}")
    if x.dtype != torch.bfloat16 or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes bfloat16 x, B and C on the card; got {x.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes dt in float32; got {dt.dtype}")
    if x.stride(3) != 1 or Bm.stride(3) != 1 or dt.stride(2) != 1:
        raise ValueError("ssd_scan: the last dim of x, B, C and dt must be contiguous")
    if Cm.stride() != Bm.stride():
        raise ValueError(f"ssd_scan: B and C must share strides; got {Bm.stride()}, "
                         f"{Cm.stride()}")


def _lib():
    lib = _build.load("ssd_scan")
    if lib.ssd_scan.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan.argtypes = [p] * 8 + [ll] * 8 + [i] * 6 + [p]
        lib.ssd_scan.restype = i
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, D: torch.Tensor, chunk: int = 64):
    """(y (B, S, H, P) in x.dtype, final state (B, H, P, N) fp32)."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm, D)):
        raise NotImplementedError(
            "ssd_scan: the kernel is forward-only; training an SSM model on the card needs "
            "its backward (ROADMAP: SSM training path)")
    _build.check_device("ssd_scan", x, dt, A, Bm, Cm, D)
    check_args(x, dt, A, Bm, Cm, D)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    err = _lib().ssd_scan(x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(),
                          Cm.data_ptr(), D32.data_ptr(), y.data_ptr(), state.data_ptr(),
                          x.stride(0), x.stride(1), x.stride(2), Bm.stride(0), Bm.stride(1),
                          Bm.stride(2), dt.stride(0), dt.stride(1), Bsz, S, H, P, G, N,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
