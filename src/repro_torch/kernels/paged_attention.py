"""Paged-KV attention: the CUDA kernels' wrappers and their plain versions.

Replaces the three TPU kernels of the reference's
``kernels/paged_attention.py``: ``paged_flash_decode`` (decode attention
through a block table), ``paged_flash_prefill`` (chunk attention through a
block table, under a causal mask shifted by the chunk's start) and
``paged_kv_write`` (the in-place per-token K/V insert).  The kernels are
``csrc/paged_attention.cu`` (CUDA C++ for sm_90a; the decode kernels share
their split and combine bodies with flash-decoding, ``csrc/decode_split.cuh``;
the source notes give the designs and the bounds); the plain versions are
``ref.paged_decode_attention_ref``, ``ref.paged_prefill_attention_ref`` and
``ref.paged_kv_write_ref``.

Pools are (num_pages, page, Hkv, D), contiguous (a layer's view of the
stacked serving pools is); q, out and the new K/V rows go through their
strides.  A CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches
(``paged_decode.launches``, ``paged_prefill.launches``,
``paged_kv_write.launches``; a call counts one, however many passes it
runs).

The decode step inserts its K/V rows inside the decode kernel:
``paged_decode`` with ``k_new, v_new, page_idx, row`` writes each slot's new
row into the pools as ``paged_kv_write`` does and attends over it in the
same launch (counted in ``paged_decode.appends`` beside its launches; the
plain version is ``ref.paged_decode_append_ref``).  For each (slot, kv
head) the block of the split that holds position ``lengths[b] - 1`` does
the insert (``append_sites`` mirrors the choice).

The prefill kernel is the dense attention forward's design (its consumer
body is shared, ``csrc/attention_fwd.cuh``) with a producer that gathers
each key tile through the block table.  Its addressing is mirrored here so
that the CPU tests reach it: ``box_rows`` (the rows of one TMA box, or 0
where the page is not a multiple of 8 and rows are gathered one by one),
``prefill_key_tiles`` (the key tiles a query tile streams) and
``tile_sources`` (where each box or row of a tile comes from).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import TILE
from repro_torch.kernels.ref import (
    paged_decode_append_ref,
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


def box_rows(page: int) -> int:
    """Rows of one TMA box of the prefill kernel's K/V tiles: the largest of
    64, 32, 16 and 8 that divides the page (a box then lies in one page and
    lands where a dense box's rows would), or 0 where the page is not a
    multiple of 8 (each row is gathered by cp.async)."""
    return next((r for r in (64, 32, 16, 8) if page % r == 0), 0)


def prefill_key_tiles(q0: int, S: int, start: int, length: int, keys: int) -> range:
    """Start keys of the ``keys``-wide tiles, aligned to absolute positions,
    that the query tile of ``TILE`` rows at q0 streams: every key below the
    row's length that one of its rows (at positions ``start + i``) sees."""
    end = min(length, start + min(q0 + TILE, S))
    return range(0, max(end, 0), keys)


def tile_sources(table_row, k0: int, keys: int, page: int, length: int,
                 pool_rows: int) -> List[Tuple[int, int, int]]:
    """(first tile row, first pool row, rows) of each copy that fills the
    tile of keys [k0, k0 + keys) of one block-table row: boxes of
    ``box_rows(page)`` rows, or single rows where that is 0.  Pool rows are
    ``table_row[pos // page] * page + pos % page``; a copy that starts at or
    past ``length`` is aimed at ``pool_rows`` (past the pool: zeros)."""
    rows = box_rows(page) or 1
    out = []
    for r0 in range(0, keys, rows):
        pos = k0 + r0
        src = int(table_row[pos // page]) * page + pos % page if pos < length else pool_rows
        out.append((r0, src, rows))
    return out


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
        lib.paged_decode_append.argtypes = [p] * 13 + [i] * 6 + [i64] * 12 + [f, p]
        lib.paged_decode_append.restype = i
        lib.paged_flash_prefill.argtypes = [p] * 7 + [i] * 8 + [i64] * 7 + [f, p]
        lib.paged_flash_prefill.restype = i
        lib.paged_kv_write.argtypes = [p] * 6 + [i] * 3 + [i64] * 7 + [p]
        lib.paged_kv_write.restype = i
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_CHUNK = 256          # csrc/decode_split.cuh: keys a split
_SUB = 16             # csrc/decode_split.cuh: keys a ring stage
_decode_fns = None


def append_sites(length: int, capacity: int) -> List[Tuple[int, int]]:
    """(split, first key of the stage) of each stage where the decode
    kernel with its fused insert stores a slot's new K/V row, for one (slot,
    kv head) of a table of ``capacity`` rows: the grid's splits as
    ``csrc/paged_attention.cu`` walks them (a split at or past the length
    returns before any load, ``csrc/decode_split.cuh``), each split's
    16-key stages, and the store where the stage holds the split's last row
    and the split ends at the length (``Paged::stage``).  The site's row is
    position ``length - 1``."""
    length = min(max(length, 0), capacity)
    sites = []
    for split in range(-(-capacity // _CHUNK)):
        k0 = split * _CHUNK
        if k0 >= length:
            continue
        n = min(_CHUNK, length - k0)
        sites += [(split, key0) for key0 in range(0, n, _SUB)
                  if key0 + _SUB >= n and k0 + n == length]
    return sites


def _decode_fns_c():
    """The decode kernel's C entry points (plain, with the fused insert),
    their argument types set once."""
    global _decode_fns
    if _decode_fns is None:
        lib = _lib()
        if lib.paged_decode_splits(2 * _CHUNK + 1) != 3:
            raise RuntimeError(f"the paged decode kernel's splits are not {_CHUNK} keys")
        _decode_fns = (lib.paged_flash_decode, lib.paged_decode_append)
    return _decode_fns


def _lean_append_ok(q, k_pool, k_new, v_new, page_idx, row, dev) -> bool:
    """The append arguments' common case, by attribute reads alone."""
    want = (q.shape[0], 1, k_pool.shape[2], k_pool.shape[3])
    bf = torch.bfloat16
    return (k_new.shape == want and v_new.shape == want
            and k_new.dtype == bf and v_new.dtype == bf
            and page_idx.shape == (want[0],) and row.shape == (want[0],)
            and page_idx.dtype == torch.int32 and row.dtype == torch.int32
            and page_idx.is_contiguous() and row.is_contiguous()
            and k_new.stride(3) == 1 and v_new.stride(3) == 1
            and not (k_new.stride(0) | k_new.stride(1) | k_new.stride(2)) % 8
            and not (v_new.stride(0) | v_new.stride(1) | v_new.stride(2)) % 8
            and not (k_new.data_ptr() | v_new.data_ptr()) % 16
            and k_new.get_device() == dev and v_new.get_device() == dev
            and page_idx.get_device() == dev and row.get_device() == dev)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_table: torch.Tensor, lengths: torch.Tensor, *,
                 softcap: float = 0.0, k_new: Optional[torch.Tensor] = None,
                 v_new: Optional[torch.Tensor] = None, page_idx: Optional[torch.Tensor] = None,
                 row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 1, H, D) in q.dtype: each row's query over the first
    ``lengths[b]`` positions its block-table row maps; a row of length 0
    gives zeros.

    With ``k_new, v_new`` (B, 1, Hkv, D) and ``page_idx, row`` (B,) int32
    (all four or none), the same launch first inserts each slot's new K
    and V row in place, ``pool[page_idx[b], row[b]] = new[b, 0]``, as
    ``paged_kv_write`` does: the decode step's insert, fused.  It requires
    ``lengths[b] >= 1`` and that ``(page_idx[b], row[b])`` is the pool row
    that the table maps position ``lengths[b] - 1`` to (clamped to the
    table's capacity), as ``models.attention.paged_decode_addressing``
    gives them; the kernel then reads each live row's new K/V from
    ``k_new``/``v_new`` and no block reads a live row that another
    writes.  Rows of the null page 0 may be read torn between the slots
    that write there (idle and masked ones, whose outputs nobody reads).

    On the card the common case costs attribute reads, one allocation and
    the launch: the full checks run only to name what the kernel does not
    take, and the fp32 partials go to the card's scratch buffer
    (``_build.scratch``)."""
    append = k_new is not None
    if append != (v_new is not None) or append != (page_idx is not None) \
            or append != (row is not None):
        raise ValueError("paged_decode: pass all of k_new, v_new, page_idx and row, or none")
    if not q.is_cuda:
        if q.device.type == "cpu":
            if append:
                return paged_decode_append_ref(q, k_pool, v_pool, block_table, lengths, k_new,
                                               v_new, page_idx, row, softcap=softcap)
            return paged_decode_attention_ref(q, k_pool, v_pool, block_table, lengths,
                                              softcap=softcap)
        raise ValueError(f"paged_decode: q must lie on the CPU or a CUDA device; got {q.device}")
    plain_fn, append_fn = _decode_fns or _decode_fns_c()
    dev = q.get_device()
    qs, ks, bs = q.shape, k_pool.shape, block_table.shape
    bf = torch.bfloat16
    if (len(qs) != 4 or qs[1] != 1 or len(ks) != 4 or ks != v_pool.shape or ks[3] != qs[3]
            or qs[3] not in (64, 128) or qs[2] % ks[2] or qs[2] // ks[2] > _MAX_GROUP
            or q.dtype != bf or k_pool.dtype != bf or v_pool.dtype != bf
            or len(bs) != 2 or bs[0] != qs[0] or lengths.shape != (qs[0],)
            or block_table.dtype != torch.int32 or lengths.dtype != torch.int32
            or not (block_table.is_contiguous() and lengths.is_contiguous()
                    and k_pool.is_contiguous() and v_pool.is_contiguous())
            or q.stride(3) != 1 or q.stride(0) % 8 or q.stride(2) % 8
            or (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16
            or qs[0] > _MAX_GRID_YZ or ks[2] > _MAX_GRID_YZ
            or k_pool.get_device() != dev or v_pool.get_device() != dev
            or block_table.get_device() != dev or lengths.get_device() != dev
            or (append and not _lean_append_ok(q, k_pool, k_new, v_new, page_idx, row, dev))):
        new = (k_new, v_new, page_idx, row) if append else ()
        _build.check_device("paged_decode", q, k_pool, v_pool, block_table, lengths, *new)
        check_decode_args(q, k_pool, v_pool, block_table, lengths)
        if append:
            check_write_args(k_pool, v_pool, k_new, v_new, page_idx, row)
            if k_new.shape[0] != qs[0]:
                raise ValueError(f"paged_decode: k_new has {k_new.shape[0]} rows, q {qs[0]}")
    B, _, H, D = qs
    _, page, Hkv, _ = ks
    n_tables = bs[1]
    out = q.new_empty((B, 1, H, D))
    n = B * H * ((n_tables * page + _CHUNK - 1) // _CHUNK)
    base = _build.scratch(dev, n * (D + 2)).data_ptr()     # m (n), l (n), acc (n, D)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if append:
        err = append_fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        block_table.data_ptr(), lengths.data_ptr(), k_new.data_ptr(),
                        v_new.data_ptr(), page_idx.data_ptr(), row.data_ptr(), out.data_ptr(),
                        base, base + 4 * n, base + 8 * n, B, H, Hkv, D, page, n_tables,
                        q.stride(0), q.stride(2), page * Hkv * D, Hkv * D, D, n_tables,
                        out.stride(0), out.stride(2), k_new.stride(0), k_new.stride(2),
                        v_new.stride(0), v_new.stride(2), softcap, stream)
    else:
        err = plain_fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(), base, base + 4 * n, base + 8 * n,
                       B, H, Hkv, D, page, n_tables, q.stride(0), q.stride(2),
                       page * Hkv * D, Hkv * D, D, n_tables, out.stride(0), out.stride(2),
                       softcap, stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError {err}")
    paged_decode.launches += 1
    if append:
        paged_decode.appends += 1
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
    num_pages, page, Hkv, _ = k_pool.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = _lib().paged_flash_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
        starts.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, S, H, Hkv, D, page, block_table.shape[1], num_pages, *q.stride()[:3],
        block_table.stride(0), *out.stride()[:3], float(softcap), _stream(q))
    if err == -1:
        raise RuntimeError("paged_prefill: the driver refused a tensor map "
                           "(cuTensorMapEncodeTiled)")
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
paged_decode.appends = 0
paged_prefill.launches = 0
paged_kv_write.launches = 0
