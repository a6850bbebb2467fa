"""Fused vocab-softmax cross-entropy: the CUDA kernels' wrappers, their
plain versions, and the differentiable op that pairs them.

Replaces the TPU kernels ``fused_cross_entropy`` (``_ce_kernel``) and
``fused_cross_entropy_bwd`` (``_ce_dh_kernel``, ``_ce_dw_kernel``) of the
reference package.  The kernels are in ``csrc/cross_entropy.cu`` (CUDA C++
for sm_90a over the GEMM mainloop of ``csrc/ce_gemm.cuh``: wgmma fed by TMA
through an mbarrier ring); its source note gives the design and the bound.  The
plain versions are ``ref.cross_entropy_ref`` and
``ref.cross_entropy_bwd_ref``.

The wrappers take the reference's operands — hidden (T, D), the output
weight w (D, Vpad), targets (T,) — and the true vocab; columns >= vocab
are masked.  The kernels take bfloat16, the port's compute dtype, and read
w where it lies: an untied head as a row-major (D, Vpad) matrix, a tied
head (w = embed.T) as the (Vpad, D) table behind the view.  dw comes back
in the same layout (for the tied head, the transpose of a contiguous
(Vpad, D) gradient).  A CPU tensor goes to the plain version; a CUDA
tensor launches the kernels or raises.

The schedule is set here, from the shapes alone: the forward's vocab
splits (``vocab_splits``), the backward's vocab chunks (``chunk_tiles``)
and the token shares of its dW product (``dw_token_shares``).
``cross_entropy_fwd.launches`` and ``cross_entropy_bwd.launches`` count
wrapper calls that launch the kernels (one forward — the split pass and
the merge — counts one, and so does one backward, whatever its chunks).
``cross_entropy`` is the ``torch.autograd.Function`` that saves (hidden,
w, targets, lse), as the reference's ``ops._cross_entropy_pallas`` custom
VJP does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cross_entropy_bwd_ref, cross_entropy_ref

_SMS = 132             # H100 SXM streaming multiprocessors, one block each
_TILE = 128            # rows and columns of an output tile (csrc/ce_gemm.cuh kBM)
_DEPTH = 64            # depth of one k-slice of the pipeline (kBK)
_FWD_BLOCKS = 16 * _SMS        # forward blocks to aim for: 16 waves
_DLOGITS_BYTES = 256 << 20     # the backward's bf16 (T, chunk) dlogits buffer


def live_tiles(vocab: int) -> int:
    """Vocab tiles that hold a live column: the loops end there, not at Vpad."""
    return -(-vocab // _TILE)


def vocab_splits(T: int, vocab: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the forward: the live vocab tiles in
    runs of equal length, enough (token tile, split) blocks for ~16 waves
    over the SMs, at most one split a live tile."""
    n_live, t_tiles = live_tiles(vocab), -(-T // _TILE)
    want = max(1, min(n_live, -(-_FWD_BLOCKS // t_tiles)))
    per = -(-n_live // want)
    return -(-n_live // per), per


def chunk_tiles(T: int, vocab: int) -> int:
    """Vocab tiles in one backward chunk: the fewest chunks whose (T,
    chunk) bf16 dlogits fit ``_DLOGITS_BYTES``, the live tiles spread evenly
    over them."""
    cap = max(1, _DLOGITS_BYTES // (T * 2 * _TILE))
    n = -(-live_tiles(vocab) // cap)
    return -(-live_tiles(vocab) // n)


def dw_token_shares(out_tiles: int, T: int) -> Tuple[int, int]:
    """(shares, tokens per share) of the dW product's contraction over the
    T tokens, for a chunk of ``out_tiles`` output tiles: one share when the
    tiles fill the SMs, else as many shares as one wave of tiles over the
    SMs holds; a share is a whole number of k-slices."""
    steps = -(-T // _DEPTH)
    want = max(1, min(steps, _SMS // out_tiles))
    per = -(-steps // want) * _DEPTH
    return -(-T // per), per


def _w_layout(w: torch.Tensor) -> Tuple[bool, int]:
    """(tied, row stride) of w (D, Vpad): untied when its vocab columns
    are contiguous, tied when its D rows are (the (Vpad, D) table's view)."""
    if w.stride(1) == 1:
        return False, w.stride(0)
    if w.stride(0) == 1:
        return True, w.stride(1)
    return False, -1


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
    tied, ld = _w_layout(w)
    if ld < 0:
        raise ValueError(f"w: its vocab columns (untied (D, Vpad)) or its D rows (the tied "
                         f"(Vpad, D) table's view) must be contiguous; strides {w.stride()}")
    if ld % 8 or w.data_ptr() % 16 or (not tied and w.shape[1] % 8):
        raise ValueError(f"w: 16-byte copies need a stride that is a multiple of 8 elements, "
                         f"a 16-byte aligned start and (untied) Vpad a multiple of 8; shape "
                         f"{tuple(w.shape)}, strides {w.stride()}")
    if targets.dtype in (torch.float16, torch.bfloat16, torch.float32, torch.float64):
        raise TypeError(f"targets must be integer, got {targets.dtype}")


def _kernel(name: str, argtypes):
    fn = getattr(_build.load("cross_entropy"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_vocab(vocab: int, Vp: int) -> None:
    if not 0 < vocab <= Vp:
        raise ValueError(f"vocab must be in [1, Vpad={Vp}], got {vocab}")


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
    _check_vocab(vocab, Vp)
    loss = torch.empty(T, dtype=torch.float32, device=h.device)
    lse = torch.empty(T, dtype=torch.float32, device=h.device)
    tied, w_ld = _w_layout(w)
    splits, per = vocab_splits(T, vocab)
    tgt = targets.to(torch.int32).contiguous()
    part = torch.empty((3, splits, T), dtype=torch.float32, device=h.device)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = _kernel("cross_entropy_fwd", [p] * 6 + [i] * 4 + [i64, i64] + [i] * 3 + [p])
    err = fn(h.data_ptr(), w.data_ptr(), tgt.data_ptr(), loss.data_ptr(), lse.data_ptr(),
             part.data_ptr(), T, D, Vp, vocab, h.stride(0), w_ld, int(tied), per, splits,
             torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(f"cross_entropy_fwd kernel launch failed: cudaError {err}")
    cross_entropy_fwd.launches += 1
    return loss, lse


def cross_entropy_bwd(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                      lse: torch.Tensor, g_loss: torch.Tensor, g_lse: torch.Tensor, *,
                      vocab: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh (T, D) in h.dtype, dw (D, Vpad) in w.dtype, laid out as w)."""
    vocab = vocab or w.shape[1]
    if h.device.type == "cpu":
        return cross_entropy_bwd_ref(h, w, targets, lse, g_loss, g_lse, vocab)
    _build.check_device("cross_entropy_bwd", h, w, targets, lse, g_loss, g_lse)
    check_args(h, w, targets)
    T, D = h.shape
    Vp = w.shape[1]
    _check_vocab(vocab, Vp)
    tied, w_ld = _w_layout(w)
    lse, gl, gs = (x.to(torch.float32).contiguous() for x in (lse, g_loss, g_lse))
    if not lse.shape == gl.shape == gs.shape == (T,):
        raise ValueError(f"lse, g_loss, g_lse must be ({T},); got "
                         f"{tuple(lse.shape)}, {tuple(gl.shape)}, {tuple(gs.shape)}")
    dh = torch.empty((T, D), dtype=h.dtype, device=h.device)
    dw = torch.empty((Vp, D) if tied else (D, Vp), dtype=w.dtype, device=h.device)
    tgt = targets.to(torch.int32).contiguous()
    per_chunk = chunk_tiles(T, vocab)
    shares, k_per_share = dw_token_shares(per_chunk * -(-D // _TILE), T)
    dl = torch.empty((T, per_chunk * _TILE), dtype=torch.bfloat16, device=h.device)
    dh_sum = (torch.empty((T, D), dtype=torch.float32, device=h.device)
              if per_chunk < live_tiles(vocab) else None)
    partial = (torch.empty((shares, per_chunk * _TILE, D), dtype=torch.float32, device=h.device)
               if shares > 1 else None)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = _kernel("cross_entropy_bwd", [p] * 11 + [i] * 4 + [i64, i64] + [i] * 3 + [p])
    err = fn(h.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(), gl.data_ptr(),
             gs.data_ptr(), dh.data_ptr(), dw.data_ptr(), dl.data_ptr(),
             None if dh_sum is None else dh_sum.data_ptr(),
             None if partial is None else partial.data_ptr(),
             T, D, Vp, vocab, h.stride(0), w_ld, int(tied), per_chunk, k_per_share,
             torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(f"cross_entropy_bwd kernel launch failed: cudaError {err}")
    cross_entropy_bwd.launches += 1
    return dh, (dw.t() if tied else dw)


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
