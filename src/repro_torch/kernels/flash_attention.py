"""Flash attention: the CUDA kernels' wrappers, their plain versions, the
host side of their schedule, and the differentiable op that pairs them.

Replaces the TPU kernels ``flash_attention_fwd`` (``_fa_kernel``) and
``flash_attention_bwd`` (``_fa_delta_kernel``, ``_fa_dq_kernel``,
``_fa_dkv_kernel``) of the reference package.  The kernels are
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` (CUDA
C++ for sm_90a on ``csrc/hopper.cuh``: TMA-fed wgmma, a producer warp and
two consumer warpgroups, P and dS kept in registers, fp32 softmax math);
their source notes give the design and the bound.  The plain versions are
``ref.attention_ref`` and ``ref.attention_bwd_ref``.

Both wrappers take the reference's layout — q (B, S, H, D), k/v (B, T,
Hkv, D), lse (B·H, S) — through strides: the kernels read q, k, v and dO
through 4-D tensor maps (``tma_geometry``).  A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises.
``flash_attention_fwd.launches`` and ``flash_attention_bwd.launches`` count
wrapper calls that launched; one backward call (Δ pre-pass, dQ pass, dK/dV
pass) counts one.  ``attention`` is the ``torch.autograd.Function`` that
saves (q, k, v, out, lse) in the forward and runs the backward from them,
as the reference's ``ops._attention_pallas`` custom VJP does.

The schedule's host side lives here so that the CPU tests reach it:
``work_items`` (the persistent blocks' order of output tiles),
``key_tiles`` / ``query_tiles`` (the tiles a work item streams) and
``needs_mask``; the kernels compute the same from their arguments.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}
TILE = 128          # rows of a work item's output tile (the kernels' kBM)
FWD_KEYS = {64: 128, 128: 64}   # keys a forward step takes, by head dim (flash_attention_fwd.cu)
BWD_ROWS = 64       # rows of a streamed tile in both backward passes (flash_attention_bwd.cu kBN)
_STRIDE_LIMIT = 1 << 40     # TMA: byte strides below 2^40, multiples of 16


def tma_geometry(t: torch.Tensor) -> Tuple[int, ...]:
    """The 4-D tensor map the kernels build over a (B, L, heads, D) operand:
    its extents (D, L, heads, B), innermost first, then the byte strides of
    L, heads and B.  A dimension of size 1 is only read at index 0, so it
    takes the contiguous layout's stride in place of the one its view
    carries."""
    B, L, N, D = t.shape
    contiguous = (L * N * D, N * D, D)
    sb, sl, sn = (s if n > 1 else c for s, n, c in zip(t.stride()[:3], (B, L, N), contiguous))
    es = t.element_size()
    return (D, L, N, B, sl * es, sn * es, sb * es)


def work_items(n_tiles: int, n_heads: int, causal: bool, heavy_last: bool) -> List[Tuple[int, int]]:
    """(output tile, b·heads) of each work item, in the order the persistent
    blocks take them (block i takes items i, i + grid, ...): under causal
    masking tile-major with the heaviest tile first — the last query tile
    (``heavy_last``: the forward and the dQ pass) or the first key tile (the
    dK/dV pass) — else head-major, so that neighbours share K and V."""
    if causal:
        return [(n_tiles - 1 - i // n_heads if heavy_last else i // n_heads, i % n_heads)
                for i in range(n_tiles * n_heads)]
    return [(i % n_tiles, i // n_tiles) for i in range(n_tiles * n_heads)]


def grid_blocks(n_items: int, sms: int) -> int:
    """Blocks of a persistent pass: one an SM, no more than its items."""
    return min(n_items, sms)


def key_tiles(q0: int, S: int, T: int, *, causal: bool, window: int, q_offset: int,
              keys: int) -> range:
    """Start keys of the ``keys``-wide key tiles that the query tile of
    ``TILE`` rows at q0 streams: those that any of its rows can see."""
    end, begin = T, 0
    if causal:
        end = min(end, min(q0 + TILE, S) - 1 + q_offset + 1)
    if window > 0:
        begin = max(0, q0 + q_offset - window + 1)
    begin = begin // keys * keys
    return range(begin, max(begin, end), keys)


def query_tiles(k0: int, S: int, *, causal: bool, window: int, q_offset: int) -> range:
    """Start rows of the ``BWD_ROWS``-row query tiles that the dK/dV pass
    streams for the key tile of ``TILE`` keys at k0."""
    begin, end = 0, S
    if causal:
        begin = max(0, k0 - q_offset)
    if window > 0:
        end = min(end, max(0, k0 + TILE - 1 + window - q_offset))
    begin = begin // BWD_ROWS * BWD_ROWS
    return range(begin, max(begin, end), BWD_ROWS)


def needs_mask(q0: int, n_q: int, k0: int, n_k: int, S: int, T: int, *, causal: bool,
               window: int, q_offset: int) -> bool:
    """Whether the (n_q queries at q0) x (n_k keys at k0) tile holds a pair
    that is masked or out of range; every other tile skips the mask.  (The
    forward and the dQ pass leave out the rows past S: those are not
    written.)"""
    return (q0 + n_q > S or k0 + n_k > T
            or (causal and k0 + n_k - 1 > q0 + q_offset)
            or (window > 0 and k0 <= q0 + n_q - 1 + q_offset - window))


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
    if min(q.numel(), k.numel()) == 0:
        raise ValueError(f"flash attention kernels take no empty operand: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    for name, t in zip(("q", "k", "v", "out", "dO"), (q, k, v, *more)):
        # TMA boxes and 16-byte loads: a contiguous head dim, every other
        # stride a positive multiple of 16 bytes below 2^40, a 16-byte start
        strides = tma_geometry(t)[4:]
        if (t.stride(3) != 1 or any(s <= 0 or s % 16 or s >= _STRIDE_LIMIT for s in strides)
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: head dim must be contiguous and every other stride a "
                             f"positive multiple of 8 elements (16 bytes) below 2^40 bytes, "
                             f"the start 16-byte aligned (the kernels' TMA copies); strides "
                             f"{t.stride()}")


def _geometry(*ts: torch.Tensor):
    vals = [x for t in ts for x in tma_geometry(t)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _fwd_kernel():
    fn = _build.load("flash_attention_fwd").flash_attention_fwd
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p] + [i64] * 3 + [i, i, ctypes.c_float, i, p]
        fn.restype = i
    return fn


def _bwd_kernel():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 7 + [p, p, i, i, ctypes.c_float, i, p]
        fn.restype = i
    return fn


def _raise_on(name: str, err: int) -> None:
    if err == -1:
        raise RuntimeError(f"{name}: the driver refused a tensor map (cuTensorMapEncodeTiled)")
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


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
    geo = _geometry(q, k, v)
    err = _fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, T, H, Hkv, D, ctypes.addressof(geo), *out.stride()[:3],
        int(causal), int(window), float(softcap), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on("flash_attention_fwd", err)
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
    geo = _geometry(q, k, v, do)
    strides = [s for t in (out, do, dq, dk, dv) for s in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(strides))(*strides)
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, T, H, Hkv, D, ctypes.addressof(geo),
        ctypes.addressof(strides), int(causal), int(window), float(softcap), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on("flash_attention_bwd", err)
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
