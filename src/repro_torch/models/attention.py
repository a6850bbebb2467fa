"""GQA self-attention: projections with optional biases, RoPE, and the
attention ops, for the full-sequence ``train`` / ``prefill`` modes, the
one-token ``decode`` mode over a dense or a paged KV cache, and the
``chunk`` mode (a bounded piece of an incremental prefill over the paged
cache).

Dense cache: {"k": (B, T, Hkv, D), "v": (B, T, Hkv, D)}, the reference's.
A decode step writes the new token's K/V into the cache in place — one
indexed write of B rows, where the reference's per-slot path selects over
the whole (B, T) buffer; the same values land in the same places — and
returns the same tensors.  Sliding-window caches are rolling: the write
goes to ``pos % T``.

Paged cache: {"k_pool": (P, page, Hkv, D), "v_pool": ...}, one layer's
view of pools shared by every slot, read and written through a (B,
pages_per_seq) block table of physical page ids (``init_paged_cache``;
the allocator is ``serving/paged_cache.py``).  The writes are in place,
where the reference donates the pools and returns new ones.

Cross-attention (a ``"len"`` cache) comes with a later slice (ROADMAP);
it raises here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import P
from repro_torch.kernels import ops
from repro_torch.models.layers import rope


def attention_defs(cfg: ModelConfig) -> Dict[str, P]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    defs: Dict[str, P] = {
        "wq": P((d, nq * hd), ("fsdp", "tp"), fan_in=d),
        "wk": P((d, nkv * hd), ("fsdp", "tp"), fan_in=d),
        "wv": P((d, nkv * hd), ("fsdp", "tp"), fan_in=d),
        "wo": P((nq * hd, d), ("tp", "fsdp"), fan_in=nq * hd),
    }
    if cfg.qkv_bias:
        defs["bq"] = P((nq * hd,), ("tp",), init="zeros")
        defs["bk"] = P((nkv * hd,), ("tp",), init="zeros")
        defs["bv"] = P((nkv * hd,), ("tp",), init="zeros")
    if cfg.attn_out_bias:
        defs["bo"] = P((d,), (None,), init="zeros")
    return defs


def _project_qkv(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor):
    """Returns q (B,S,H,D), k, v (B,S,Hkv,D)."""
    cdt = x.dtype
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"].to(cdt)
    k = x @ params["wk"].to(cdt)
    v = x @ params["wv"].to(cdt)
    if "bq" in params:
        q = q + params["bq"].to(cdt)
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)
    return (q.reshape(B, S, cfg.num_heads, hd),
            k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


def _out_proj(cfg: ModelConfig, params: Dict[str, Any], o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    out = o.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim) @ params["wo"].to(o.dtype)
    if "bo" in params:
        out = out + params["bo"].to(o.dtype)
    return out


def attention_apply(
    cfg: ModelConfig,
    params: Dict[str, Any],
    x: torch.Tensor,                      # (B, S, d_model)
    *,
    positions: Optional[torch.Tensor] = None,
    mode: str = "train",                  # train | prefill | decode | chunk
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Union[None, int, torch.Tensor] = None,   # int, or (B,) per slot
    causal: Optional[bool] = None,
    window: Optional[int] = None,
    paged: Optional[Dict[str, torch.Tensor]] = None,   # paged layout's addressing
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out (B,S,d_model), cache): {"k", "v"} of this call's rows in
    prefill mode, the updated cache in decode and chunk modes, None in
    train mode.

    Decode: ``cache_pos`` is the write position — an int for lockstep rows
    (every row at the same position) or a (B,) tensor for per-slot
    positions (the serving engine); row b then attends over its first
    min(pos_b + 1, T) cache rows.  Over a paged cache it is a (B,) tensor
    and ``paged`` is ``paged_decode_addressing`` of the step.

    Chunk (paged cache, batch 1): the S rows sit at positions ``cache_pos
    + [0, S)``, and ``paged`` is ``paged_chunk_addressing`` of the chunk;
    rows past its valid count are bucket padding, whose K/V goes to the
    null page and whose outputs the caller discards."""
    if mode not in ("train", "prefill", "decode", "chunk") or (
            cache is not None and "len" in cache):
        raise NotImplementedError(
            f"attention mode {mode!r} with this cache is not ported yet "
            f"(ROADMAP: the cross-attention slice)"
        )
    causal = cfg.causal if causal is None else causal
    window = cfg.sliding_window if window is None else window
    q, k, v = _project_qkv(cfg, params, x)
    per_slot = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
    if cfg.use_rope:
        if positions is None:
            if mode == "decode":
                positions = (cache_pos[:, None] if per_slot
                             else torch.full((x.shape[1],), int(cache_pos), device=x.device))
            else:
                positions = torch.arange(x.shape[1], device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if mode == "chunk" or (mode == "decode" and cache is not None and "k_pool" in cache):
        # the paged layout: K/V rows written through the block table, then
        # attention over the pools.  A chunk writes only pages the slot owns
        # alone: the engine privatizes a shared prefix page (copy-on-write)
        # before a chunk writes into it
        if cache is None or "k_pool" not in cache or paged is None:
            raise ValueError(f"mode={mode!r} over the paged layout needs the page pools and "
                             f"the step's paging addresses")
        k_pool, v_pool = cache["k_pool"], cache["v_pool"]
        if mode == "chunk":
            if x.shape[0] != 1:
                raise ValueError("chunked prefill processes one slot at a time")
            ops.paged_kv_update_rows(k_pool, v_pool, k[0], v[0], paged["page_idx"], paged["row"])
            o = ops.paged_prefill_attention(q, k_pool, v_pool, paged["block_table"],
                                            paged["starts"], paged["lengths"],
                                            softcap=cfg.attn_logit_softcap, impl=cfg.kernel_impl)
        else:
            ops.paged_kv_update(k_pool, v_pool, k, v, paged["page_idx"], paged["row"],
                                impl=cfg.kernel_impl)
            o = ops.paged_decode_attention(q, k_pool, v_pool, paged["block_table"],
                                           paged["lengths"], softcap=cfg.attn_logit_softcap,
                                           impl=cfg.kernel_impl)
        return _out_proj(cfg, params, o), cache

    if mode == "decode":
        if cache is None or cache_pos is None:
            raise ValueError("decode mode needs a cache and cache_pos")
        k_cache, v_cache = cache["k"], cache["v"]
        B, T = k_cache.shape[0], k_cache.shape[1]
        rolling = bool(window) and window <= T
        # a position past a non-rolling cache writes its last row (the
        # reference's scalar write clamps there; the engine never gets there)
        if per_slot:
            widx = cache_pos.long() % T if rolling else cache_pos.long().clamp(max=T - 1)
            rows = torch.arange(B, device=x.device)
            k_cache.index_put_((rows, widx), k[:, 0].to(k_cache.dtype))
            v_cache.index_put_((rows, widx), v[:, 0].to(v_cache.dtype))
            lengths = torch.clamp(cache_pos + 1, max=T).to(torch.int32)
        else:
            pos = int(cache_pos)
            widx = pos % T if rolling else min(pos, T - 1)
            k_cache[:, widx] = k[:, 0].to(k_cache.dtype)
            v_cache[:, widx] = v[:, 0].to(v_cache.dtype)
            lengths = torch.full((B,), min(pos + 1, T), dtype=torch.int32, device=x.device)
        o = ops.decode_attention(q, k_cache, v_cache, lengths,
                                 softcap=cfg.attn_logit_softcap, impl=cfg.kernel_impl)
        return _out_proj(cfg, params, o), cache

    o = ops.attention(q, k, v, causal=causal, window=window,
                      softcap=cfg.attn_logit_softcap, impl=cfg.kernel_impl)
    out = _out_proj(cfg, params, o)
    return out, ({"k": k, "v": v} if mode == "prefill" else None)


def cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> Tuple[int, int, int, int]:
    """(batch, T, Hkv, D) of a dense cache; T = min(max_len, window) for a
    sliding-window model (a rolling cache)."""
    T = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return (batch, T, cfg.num_kv_heads, cfg.resolved_head_dim)



def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, dtype: torch.dtype,
                     device: torch.device, stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Zeroed K/V page pools, {"k_pool", "v_pool"} of shape (*stack,
    num_pages, page_size, Hkv, D); the stack builds all layers' pools at
    once with ``stack=(num_layers,)``.  The block table lives at the engine
    cache's top level: it is the same for every layer.  Raises for a
    sliding-window model: the paged layout has no rolling cache."""
    if cfg.sliding_window:
        raise ValueError(
            "cache_layout='paged' does not support sliding-window (rolling) "
            "caches — use the dense layout"
        )
    shape = (*stack, num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {n: torch.zeros(shape, dtype=dtype, device=device) for n in ("k_pool", "v_pool")}


def paged_decode_addressing(block_table: torch.Tensor, pos: torch.Tensor, page_size: int
                            ) -> Dict[str, torch.Tensor]:
    """A paged decode step's addresses, the same for every layer (the
    model computes them once a step): slot b writes its token at position
    ``pos[b]`` clamped to the table's capacity, in page ``page_idx[b]``
    row ``row[b]``, and attends over ``lengths[b] = min(pos[b] + 1,
    capacity)`` rows.  All int32, beside the (B, pages_per_seq) table."""
    capacity = block_table.shape[1] * page_size
    cp = torch.clamp(pos, max=capacity - 1)
    return {"block_table": block_table,
            "page_idx": block_table.gather(1, (cp // page_size)[:, None].long())[:, 0],
            "row": (cp % page_size).to(torch.int32),
            "lengths": torch.clamp(pos + 1, max=capacity).to(torch.int32)}


def paged_chunk_addressing(block_row: torch.Tensor, start: int, size: int, n_valid: int,
                           page_size: int) -> Dict[str, torch.Tensor]:
    """A chunk's addresses, the same for every layer: its ``size`` rows sit
    at positions ``start + [0, size)``; row i writes page ``page_idx[i]``
    row ``row[i]`` (the null page 0 for the padding rows ``>= n_valid``),
    and attention runs over positions ``[0, start + n_valid)``.  ``starts``
    and ``lengths`` are (1,) int32, beside the (1, pages_per_seq) table
    row."""
    dev = block_row.device
    rows = torch.arange(size, device=dev)
    pos = start + rows
    page_idx = block_row[0, torch.clamp(pos // page_size, 0, block_row.shape[1] - 1)]
    return {"block_table": block_row,
            "page_idx": torch.where(rows < n_valid, page_idx, 0),
            "row": pos % page_size,
            "starts": torch.full((1,), start, dtype=torch.int32, device=dev),
            "lengths": torch.full((1,), start + n_valid, dtype=torch.int32, device=dev)}
