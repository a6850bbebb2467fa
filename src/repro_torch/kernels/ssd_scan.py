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

Differentiable on every device: ``SSDScan`` (a ``torch.autograd.Function``)
saves the state entering each chunk in its forward and computes dx, ddt,
dA, dB, dC and dD in its backward, ``ssd_scan_bwd``.  On the card its
halves are the forward kernel, which then also stores the chunk states
(the ``ssd_scan_states`` entry), and the backward kernel
``csrc/ssd_scan_bwd.cu``, the port's own (the reference's TPU kernel has
no backward: it trains through XLA's autodiff of ``_ssd_chunked_xla``).
On the CPU they are the plain ``ssd_scan_ref(..., states=True)`` and
``ssd_scan_bwd_ref``.  A CPU tensor goes to the plain versions; a CUDA
tensor launches the kernels or raises.  The kernels chunk at their own 64
rows, whatever ``chunk`` says: the function does not depend on the chunk
beyond fp32 rounding, and ``chunk`` reaches only the plain versions.  x,
B and C may be strided views (the SSM block slices them out of one
activation) as long as their last dim is contiguous.  ``ssd_scan.launches``
counts forward launches and ``ssd_scan_bwd.launches`` backward ones (four
kernels a launch).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref

_P_TILE = 32     # rows of the state per block
_MAX_N = 128     # the block's shared-memory tiles are sized for N <= 128
_L = 64          # the kernels' chunk


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


def check_bwd_args(x: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                   dstate: Optional[torch.Tensor], N: int) -> None:
    """Raise on a backward operand the kernel does not take (after
    ``check_args`` on the forward's)."""
    Bsz, S, H, P = x.shape
    nc = -(-S // _L)
    if states.shape != (Bsz, nc, H, P, N) or states.dtype != torch.float32:
        raise ValueError(f"ssd_scan_bwd: states must be fp32 {(Bsz, nc, H, P, N)} (chunks of "
                         f"{_L}); got {states.dtype} {tuple(states.shape)}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: dy must be {x.dtype} {tuple(x.shape)}; got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dstate is not None and (dstate.shape != (Bsz, H, P, N) or dstate.dtype != torch.float32):
        raise ValueError(f"ssd_scan_bwd: dstate must be fp32 {(Bsz, H, P, N)}; got "
                         f"{dstate.dtype} {tuple(dstate.shape)}")
    if not (states.is_contiguous() and dy.is_contiguous()
            and (dstate is None or dstate.is_contiguous())):
        raise ValueError("ssd_scan_bwd: states, dy and dstate must be contiguous")


def _lib(name: str = "ssd_scan"):
    lib = _build.load(name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "ssd_scan" and lib.ssd_scan.argtypes is None:
        lib.ssd_scan.argtypes = [p] * 8 + [ll] * 8 + [i] * 6 + [p]
        lib.ssd_scan.restype = i
        lib.ssd_scan_states.argtypes = [p] * 9 + [ll] * 8 + [i] * 6 + [p]
        lib.ssd_scan_states.restype = i
    if name == "ssd_scan_bwd" and lib.ssd_scan_bwd.argtypes is None:
        lib.ssd_scan_bwd.argtypes = [p] * 20 + [ll] * 8 + [i] * 6 + [p]
        lib.ssd_scan_bwd.restype = i
    return lib


def _scan(x, dt, A, Bm, Cm, D, chunk: int, states: bool):
    """The forward on either device -> (y, final state[, chunk states])."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk, states=states)
    _build.check_device("ssd_scan", x, dt, A, Bm, Cm, D)
    check_args(x, dt, A, Bm, Cm, D)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    hin = (torch.empty((Bsz, -(-S // _L), H, P, N), dtype=torch.float32, device=x.device)
           if states else None)
    lib = _lib()
    head = [x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D32.data_ptr(), y.data_ptr(), state.data_ptr()]
    tail = [x.stride(0), x.stride(1), x.stride(2), Bm.stride(0), Bm.stride(1), Bm.stride(2),
            dt.stride(0), dt.stride(1), Bsz, S, H, P, G, N,
            torch.cuda.current_stream(x.device).cuda_stream]
    err = (lib.ssd_scan_states(*head, hin.data_ptr(), *tail) if states
           else lib.ssd_scan(*head, *tail))
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return (y, state, hin) if states else (y, state)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, D: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                 dstate: Optional[torch.Tensor] = None, chunk: int = 64):
    """The scan's backward -> (dx in x.dtype, ddt fp32, dA in A.dtype, dB
    and dC in Bm.dtype, dD in D.dtype), given the forward's inputs, the
    state entering each chunk (``states``, from the forward at the same
    chunk: 64 rows on the card) and the gradients of y and of the final
    state (or None)."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_ref(x, dt, A, Bm, Cm, D, states, dy, dstate, chunk)
    _build.check_device("ssd_scan_bwd", x, dt, A, Bm, Cm, D, states, dy,
                        *(() if dstate is None else (dstate,)))
    check_args(x, dt, A, Bm, Cm, D)
    dy = dy.contiguous()
    N = Bm.shape[3]
    check_bwd_args(x, states, dy, dstate, N)
    Bsz, S, H, P = x.shape
    G, nc = Bm.shape[2], states.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    dh = torch.empty_like(states)
    dBp, dCp = torch.empty((2, Bsz, S, H, N), **f32)
    dAp, dDp = torch.empty((2, Bsz, nc, H), **f32)
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bsz, S, H), **f32)
    dB, dC = (torch.empty((Bsz, S, G, N), dtype=Bm.dtype, device=x.device) for _ in range(2))
    dA, dD = (torch.empty(H, **f32) for _ in range(2))
    err = _lib("ssd_scan_bwd").ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        D32.data_ptr(), states.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dh.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), dDp.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), x.stride(0), x.stride(1),
        x.stride(2), Bm.stride(0), Bm.stride(1), Bm.stride(2), dt.stride(0), dt.stride(1), Bsz, S,
        H, P, G, N, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError {err}")
    ssd_scan_bwd.launches += 1
    return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, dD.to(D.dtype)


ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """The scan with its backward: the forward keeps the state entering each
    chunk, the backward is ``ssd_scan_bwd`` (kernel or plain by device)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        y, state, states = _scan(x, dt, A, Bm, Cm, D, chunk, states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, D, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        return (*ssd_scan_bwd(x, dt, A, Bm, Cm, D, states, dy, dstate, ctx.chunk), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, D: torch.Tensor, chunk: int = 64):
    """(y (B, S, H, P) in x.dtype, final state (B, H, P, N) fp32);
    differentiable through ``SSDScan`` when an input needs a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm, D)):
        return SSDScan.apply(x, dt, A, Bm, Cm, D, chunk)
    return _scan(x, dt, A, Bm, Cm, D, chunk, states=False)


ssd_scan.launches = 0
