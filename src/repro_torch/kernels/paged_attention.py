"""Paged-KV attention: the CUDA kernels' wrappers and their plain versions.

Replaces the three TPU kernels of the reference's
``kernels/paged_attention.py``: ``paged_flash_decode`` (decode attention
through a block table), ``paged_flash_prefill`` (chunk attention through a
block table, under a causal mask shifted by the chunk's start) and
``paged_kv_write`` (the in-place per-token K/V insert).  The kernels are
``csrc/paged_attention.cu`` (CUDA C++ for sm_90a; its source note gives the
designs and the bounds); the plain versions are
``ref.paged_decode_attention_ref``, ``ref.paged_prefill_attention_ref`` and
``ref.paged_kv_write_ref``.

Pools are (num_pages, page, Hkv, D), contiguous (a layer's view of the
stacked serving pools is); q, out and the new K/V rows go through their
strides.  A CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches
(``paged_decode.launches``, ``paged_prefill.launches``,
``paged_kv_write.launches``; a call counts one, however many passes it
runs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    paged_decode_attention_ref,
    paged_kv_write_ref,
    paged_prefill_attention_ref,
)

_MAX_GROUP = 16
_MAX_GRID_YZ = 65535


def _check_pools(name: str, k_pool: torch.Tensor, v_pool: torch.Tensor, D: int) -> None:
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != D:
        raise ValueError(f"{name}: pools must be (num_pages, page, Hkv, {D}) and alike; got "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{name}: pools must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: pools must be 16-byte aligned")


def _check_int32(name: str, **vecs: torch.Tensor) -> None:
    for what, t in vecs.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous int32; got {t.dtype}, "
                             f"strides {t.stride()}")


def _check_rows(name: str, **rows: torch.Tensor) -> None:
    """16-byte vector access of each head row: contiguous head dim, every
    other stride a multiple of 8 elements, 16-byte aligned."""
    for what, t in rows.items():
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what}: head dim must be contiguous and every other stride "
                             f"a multiple of 8 elements (16 bytes); strides {t.stride()}")


def _check_attention(name: str, q, k_pool, v_pool, block_table, **vecs) -> None:
    B, _, H, D = q.shape
    Hkv = k_pool.shape[2] if k_pool.dim() == 4 else 0
    if q.dtype != torch.bfloat16 or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name} takes bfloat16 operands on the card; got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if D not in (64, 128):
        raise ValueError(f"{name} supports head_dim 64 or 128, got {D}")
    _check_pools(name, k_pool, v_pool, D)
    if H % Hkv:
        raise ValueError(f"{name}: {H} query heads do not divide into {Hkv} kv heads")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"{name}: block_table must be ({B}, pages_per_seq); got "
                         f"{tuple(block_table.shape)}")
    _check_int32(name, block_table=block_table, **vecs)
    for what, t in vecs.items():
        if t.shape != (B,):
            raise ValueError(f"{name}: {what} must be ({B},); got {tuple(t.shape)}")
    _check_rows(name, q=q)


def check_decode_args(q, k_pool, v_pool, block_table, lengths) -> None:
    """Raise on what the decode kernel does not take (any device)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode: expected q (B, 1, H, D); got {tuple(q.shape)}")
    _check_attention("paged_decode", q, k_pool, v_pool, block_table, lengths=lengths)
    B, _, H, _ = q.shape
    if H // k_pool.shape[2] > _MAX_GROUP:
        raise ValueError(f"paged_decode: GQA group at most {_MAX_GROUP}")
    if B > _MAX_GRID_YZ or k_pool.shape[2] > _MAX_GRID_YZ:
        raise ValueError(f"paged_decode: batch {B} or kv heads exceed the kernel's grid limit")


def check_prefill_args(q, k_pool, v_pool, block_table, starts, lengths) -> None:
    """Raise on what the prefill kernel does not take (any device)."""
    if q.dim() != 4:
        raise ValueError(f"paged_prefill: expected q (B, S, H, D); got {tuple(q.shape)}")
    _check_attention("paged_prefill", q, k_pool, v_pool, block_table, starts=starts,
                     lengths=lengths)
    if q.shape[0] * q.shape[2] > _MAX_GRID_YZ:
        raise ValueError("paged_prefill: batch x heads exceed the kernel's grid limit")


def check_write_args(k_pool, v_pool, k_new, v_new, page_idx, row) -> None:
    """Raise on what the insert kernel does not take (any device)."""
    D = k_pool.shape[-1]
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_kv_write takes bfloat16 pools on the card; got {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if D % 8:
        raise ValueError(f"paged_kv_write: head_dim {D} is not a multiple of 8")
    _check_pools("paged_kv_write", k_pool, v_pool, D)
    B = k_new.shape[0]
    want = (B, 1, k_pool.shape[2], D)
    if tuple(k_new.shape) != want or tuple(v_new.shape) != want:
        raise ValueError(f"paged_kv_write: k_new, v_new must be {want}; got "
                         f"{tuple(k_new.shape)}, {tuple(v_new.shape)}")
    if k_new.dtype != k_pool.dtype or v_new.dtype != k_pool.dtype:
        raise TypeError(f"paged_kv_write: new rows must be {k_pool.dtype}")
    _check_int32("paged_kv_write", page_idx=page_idx, row=row)
    if page_idx.shape != (B,) or row.shape != (B,):
        raise ValueError(f"paged_kv_write: page_idx and row must be ({B},)")
    _check_rows("paged_kv_write", k_new=k_new, v_new=v_new)


def _lib():
    lib = _build.load("paged_attention")
    if lib.paged_flash_decode.argtypes is None:
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.paged_decode_splits.argtypes = [i]
        lib.paged_decode_splits.restype = i
        lib.paged_flash_decode.argtypes = [p] * 9 + [i] * 6 + [i64] * 8 + [f, p]
        lib.paged_flash_decode.restype = i
        lib.paged_flash_prefill.argtypes = [p] * 7 + [i] * 7 + [i64] * 10 + [f, p]
        lib.paged_flash_prefill.restype = i
        lib.paged_kv_write.argtypes = [p] * 6 + [i] * 3 + [i64] * 7 + [p]
        lib.paged_kv_write.restype = i
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_table: torch.Tensor, lengths: torch.Tensor, *,
                 softcap: float = 0.0) -> torch.Tensor:
    """(B, 1, H, D) in q.dtype: each row's query over the first
    ``lengths[b]`` positions its block-table row maps; a row of length 0
    gives zeros."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_table, lengths,
                                          softcap=softcap)
    _build.check_device("paged_decode", q, k_pool, v_pool, block_table, lengths)
    check_decode_args(q, k_pool, v_pool, block_table, lengths)
    B, _, H, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    n_tables = block_table.shape[1]
    lib = _lib()
    splits = lib.paged_decode_splits(n_tables * page)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    n = B * H * splits
    part = torch.empty((n * (D + 2),), dtype=torch.float32, device=q.device)
    err = lib.paged_flash_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part.data_ptr(), part[n:].data_ptr(),
        part[2 * n:].data_ptr(), B, H, Hkv, D, page, n_tables, q.stride(0), q.stride(2),
        *k_pool.stride()[:3], block_table.stride(0), out.stride(0), out.stride(2),
        float(softcap), _stream(q))
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError {err}")
    paged_decode.launches += 1
    return out


def paged_prefill(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_table: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor, *,
                  softcap: float = 0.0) -> torch.Tensor:
    """(B, S, H, D) in q.dtype: query row i of batch b at position
    ``starts[b] + i`` over the keys ``k <= starts[b] + i``, ``k <
    lengths[b]`` through the block table; a fully masked row gives zeros."""
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pool, v_pool, block_table, starts, lengths,
                                           softcap=softcap)
    _build.check_device("paged_prefill", q, k_pool, v_pool, block_table, starts, lengths)
    check_prefill_args(q, k_pool, v_pool, block_table, starts, lengths)
    B, S, H, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = _lib().paged_flash_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
        starts.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, S, H, Hkv, D, page, block_table.shape[1], *q.stride()[:3],
        *k_pool.stride()[:3], block_table.stride(0), *out.stride()[:3],
        float(softcap), _stream(q))
    if err:
        raise RuntimeError(f"paged_prefill kernel launch failed: cudaError {err}")
    paged_prefill.launches += 1
    return out


def paged_kv_write(k_pool: torch.Tensor, v_pool: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, page_idx: torch.Tensor, row: torch.Tensor) -> None:
    """In place: ``pool[page_idx[b], row[b]] = new[b, 0]`` for K and V, one
    launch for both.  k_new, v_new (B, 1, Hkv, D); idle slots all aim at
    the null page 0."""
    if k_pool.device.type == "cpu":
        paged_kv_write_ref(k_pool, v_pool, k_new, v_new, page_idx, row)
        return
    _build.check_device("paged_kv_write", k_pool, v_pool, k_new, v_new, page_idx, row)
    check_write_args(k_pool, v_pool, k_new, v_new, page_idx, row)
    _, _, Hkv, D = k_pool.shape
    err = _lib().paged_kv_write(
        k_pool.data_ptr(), v_pool.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        page_idx.data_ptr(), row.data_ptr(), k_new.shape[0], Hkv, D, *k_pool.stride()[:3],
        k_new.stride(0), k_new.stride(2), v_new.stride(0), v_new.stride(2), _stream(k_pool))
    if err:
        raise RuntimeError(f"paged_kv_write kernel launch failed: cudaError {err}")
    paged_kv_write.launches += 1


paged_decode.launches = 0
paged_prefill.launches = 0
paged_kv_write.launches = 0
