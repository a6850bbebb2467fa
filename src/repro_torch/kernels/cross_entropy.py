"""Fused vocab-softmax cross-entropy: the CUDA kernels' wrappers, their
plain versions, and the differentiable op that pairs them.

Replaces the TPU kernels ``fused_cross_entropy`` (``_ce_kernel``) and
``fused_cross_entropy_bwd`` (``_ce_dh_kernel``, ``_ce_dw_kernel``) of the
reference package.  The kernels are in ``csrc/cross_entropy.cu`` (CUDA C++
for sm_90a, mma.sync tensor cores, fp32 online LSE); its source note gives
the design and the bound.  The plain versions are ``ref.cross_entropy_ref``
and ``ref.cross_entropy_bwd_ref``.

The wrappers take the reference's operands — hidden (T, D), the output
weight w (D, Vpad), targets (T,) — and the true vocab; columns >= vocab
are masked.  The kernels take bfloat16, the port's compute dtype.  The kernels read W^T as a row-major (Vpad, D) matrix: the
wrapper passes ``w.t().contiguous()``, which for the tied head (w =
embed.T) is the embedding table itself, with no copy; an untied (D, Vpad)
head is transposed once per call.  A CPU tensor goes to the plain version;
a CUDA tensor launches the kernel or raises.
``cross_entropy_fwd.launches`` and ``cross_entropy_bwd.launches`` count
kernel launches (one backward call — the dH, dW and dW-sum passes —
counts one).  ``cross_entropy`` is the ``torch.autograd.Function`` that
saves (hidden, w, targets, lse), as the reference's
``ops._cross_entropy_pallas`` custom VJP does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cross_entropy_bwd_ref, cross_entropy_ref

_SMS = 132           # H100 SXM streaming multiprocessors
_TILE = 64           # token / vocab rows per block
_OUT = 128           # D columns per dH / dW block


def check_args(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor) -> None:
    """Raise on what the kernels do not take (any device)."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0] or targets.shape != h.shape[:1]:
        raise ValueError(f"expected hidden (T, D), w (D, Vpad), targets (T,); got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}, {tuple(targets.shape)}")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"cross-entropy kernels take bfloat16 hidden and w; got "
                        f"{h.dtype}, {w.dtype}")
    if h.shape[1] % 8:
        raise ValueError(f"cross-entropy kernels need D a multiple of 8, got {h.shape[1]}")
    if h.stride(1) != 1 or h.stride(0) % 8 or h.data_ptr() % 16:
        raise ValueError(f"hidden: rows must be contiguous with a stride that is a multiple "
                         f"of 8 elements (16 bytes); strides {h.stride()}")
    if targets.dtype in (torch.float16, torch.bfloat16, torch.float32, torch.float64):
        raise TypeError(f"targets must be integer, got {targets.dtype}")


def _kernel(name: str, argtypes):
    fn = getattr(_build.load("cross_entropy"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def dw_splits(T: int, D: int, Vp: int) -> int:
    """Shares of the token tiles the dW pass splits into: enough blocks
    for about two waves over the SMs, at most one share per tile."""
    blocks = -(-Vp // _TILE) * -(-D // _OUT)
    return max(1, min(-(-T // _TILE), -(-2 * _SMS // blocks)))


def cross_entropy_fwd(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, *,
                      vocab: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, lse), both (T,) fp32."""
    vocab = vocab or w.shape[1]
    if h.device.type == "cpu":
        return cross_entropy_ref(h, w, targets, vocab)
    _build.check_device("cross_entropy_fwd", h, w, targets)
    check_args(h, w, targets)
    T, D = h.shape
    Vp = w.shape[1]
    wt = w.t().contiguous()
    tgt = targets.to(torch.int32).contiguous()
    loss = torch.empty(T, dtype=torch.float32, device=h.device)
    lse = torch.empty(T, dtype=torch.float32, device=h.device)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = _kernel("cross_entropy_fwd", [p, p, p, p, p, i, i, i, i, i64, i64, p])
    err = fn(h.data_ptr(), wt.data_ptr(), tgt.data_ptr(), loss.data_ptr(), lse.data_ptr(),
             T, D, Vp, vocab, h.stride(0), wt.stride(0),
             torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(f"cross_entropy_fwd kernel launch failed: cudaError {err}")
    cross_entropy_fwd.launches += 1
    return loss, lse


def cross_entropy_bwd(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                      lse: torch.Tensor, g_loss: torch.Tensor, g_lse: torch.Tensor, *,
                      vocab: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh (T, D) in h.dtype, dw (D, Vpad) in w.dtype)."""
    vocab = vocab or w.shape[1]
    if h.device.type == "cpu":
        return cross_entropy_bwd_ref(h, w, targets, lse, g_loss, g_lse, vocab)
    _build.check_device("cross_entropy_bwd", h, w, targets, lse, g_loss, g_lse)
    check_args(h, w, targets)
    T, D = h.shape
    Vp = w.shape[1]
    wt = w.t().contiguous()
    tgt = targets.to(torch.int32).contiguous()
    lse, gl, gs = (x.to(torch.float32).contiguous() for x in (lse, g_loss, g_lse))
    if not lse.shape == gl.shape == gs.shape == (T,):
        raise ValueError(f"lse, g_loss, g_lse must be ({T},); got "
                         f"{tuple(lse.shape)}, {tuple(gl.shape)}, {tuple(gs.shape)}")
    splits = dw_splits(T, D, Vp)
    dh = torch.empty((T, D), dtype=h.dtype, device=h.device)
    dwt = torch.empty((Vp, D), dtype=w.dtype, device=h.device)
    partial = torch.empty((splits, Vp, D), dtype=torch.float32, device=h.device)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = _kernel("cross_entropy_bwd", [p] * 9 + [i] * 5 + [i64, i64, p])
    err = fn(h.data_ptr(), wt.data_ptr(), tgt.data_ptr(), lse.data_ptr(), gl.data_ptr(),
             gs.data_ptr(), dh.data_ptr(), dwt.data_ptr(), partial.data_ptr(), splits,
             T, D, Vp, vocab, h.stride(0), wt.stride(0),
             torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(f"cross_entropy_bwd kernel launch failed: cudaError {err}")
    cross_entropy_bwd.launches += 1
    return dh, dwt.t()


cross_entropy_fwd.launches = 0
cross_entropy_bwd.launches = 0


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, targets, vocab, plain):
        loss, lse = (cross_entropy_ref if plain else cross_entropy_fwd)(
            h, w, targets, vocab=vocab)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.vocab, ctx.plain = vocab, plain
        return loss, lse

    @staticmethod
    def backward(ctx, g_loss, g_lse):
        h, w, targets, lse = ctx.saved_tensors
        bwd = cross_entropy_bwd_ref if ctx.plain else cross_entropy_bwd
        dh, dw = bwd(h, w, targets, lse, g_loss, g_lse, vocab=ctx.vocab)
        return dh, dw, None, None, None


def cross_entropy(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, *, vocab: int = 0,
                  plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable per-token (loss, lse): the kernels, or with ``plain``
    the plain versions on any device."""
    return _CrossEntropy.apply(h, w, targets, vocab or w.shape[1], plain)
