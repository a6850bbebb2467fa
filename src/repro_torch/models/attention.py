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

On a mesh under head-TP (``ctx.head_tp``) every mode computes the rank's
query heads and their K/V heads (``parallel.sharding.rank_kv_heads``):
the dense cache and the pools hold those K/V heads only, and the output
projection is row-parallel, one all-reduce over ``model``.  Under context
parallelism only train mode runs; generation raises.

Cross-attention (an encoder-decoder's decoder layers): ``cross_kv``, the
encoder output (B, T_enc, d_model), gives K and V; it is never causal and
takes no RoPE.  In prefill mode it returns the write-once cross cache
{"k", "v": (B, T_enc, Hkv, D), "len": (B,) int32 T_enc}, the reference's
``xattn`` entry (the reference projects K/V a second time to build it; the
values are the same).  A decode step over that cache (a ``"len"`` cache)
projects only q and attends over each row's first ``len`` rows.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import P
from repro_torch.kernels import ops
from repro_torch.models.layers import rope
from repro_torch.parallel.sharding import rank_kv_heads


def attention_defs(cfg: ModelConfig, cross: bool = False) -> Dict[str, P]:
    """The projections; a cross-attention block (``cross``) has the same
    ones, as in the reference, which leaves ``cross_attn_heads`` unread."""
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


def _project_q(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,D); H is the heads ``wq`` holds (a head-TP rank's share)."""
    q = x @ params["wq"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    return q.reshape(*x.shape[:2], -1, cfg.resolved_head_dim)


def _project_qkv(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor,
                 kv_src: Optional[torch.Tensor] = None):
    """Returns q (B,S,H,D), k, v (B,T,Hkv,D); K/V from ``kv_src`` (the
    encoder output, T rows) when given, else from x (T = S)."""
    cdt = x.dtype
    src = x if kv_src is None else kv_src
    B, T = src.shape[:2]
    hd = cfg.resolved_head_dim
    k = src @ params["wk"].to(cdt)
    v = src @ params["wv"].to(cdt)
    if "bk" in params:
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)
    return (_project_q(cfg, params, x), k.reshape(B, T, -1, hd), v.reshape(B, T, -1, hd))


def _tp_kv(cfg: ModelConfig, ctx: Any, k: torch.Tensor, v: torch.Tensor):
    """Head-TP with the K/V heads replicated (``num_kv_heads % tp != 0``):
    the K/V heads of this rank's query heads (``rank_kv_heads``): the one
    K/V head when they fall inside one group, else one K/V head per query
    head.  (They never cover whole groups: that would make the K/V heads
    divide over ``tp``.)"""
    if k.shape[2] != cfg.num_kv_heads:          # sharded with the query heads
        return k, v
    idx = rank_kv_heads(cfg, ctx)
    if len(idx) == 1:
        return k.narrow(2, idx[0], 1), v.narrow(2, idx[0], 1)
    idx = torch.tensor(idx, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _out_proj(cfg: ModelConfig, params: Dict[str, Any], o: torch.Tensor,
              ctx: Any = None) -> torch.Tensor:
    """Row-parallel under head-TP: the rank's heads' rows of ``wo``, one
    all-reduce over ``model``, then ``bo`` once."""
    B, S = o.shape[:2]
    out = o.reshape(B, S, -1) @ params["wo"].to(o.dtype)
    if ctx is not None and ctx.head_tp:
        out = ctx.reduce_from_model(out)
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
    cross_kv: Optional[torch.Tensor] = None,           # encoder output (B, T_enc, d_model)
    ctx: Any = None,                                   # parallel.sharding.ShardingCtx
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out (B,S,d_model), cache): {"k", "v"} of this call's rows in
    prefill mode ({"k", "v", "len"} for cross-attention), the updated cache
    in decode and chunk modes, None in train mode.

    Cross-attention: ``cross_kv`` in train and prefill mode; in decode mode
    a ``"len"`` cache (what prefill returned) and no ``cross_kv``.

    Decode: ``cache_pos`` is the write position — an int for lockstep rows
    (every row at the same position) or a (B,) tensor for per-slot
    positions (the serving engine); row b then attends over its first
    min(pos_b + 1, T) cache rows.  Over a paged cache it is a (B,) tensor
    and ``paged`` is ``paged_decode_addressing`` of the step.

    Chunk (paged cache, batch 1): the S rows sit at positions ``cache_pos
    + [0, S)``, and ``paged`` is ``paged_chunk_addressing`` of the chunk;
    rows past its valid count are bucket padding, whose K/V goes to the
    null page and whose outputs the caller discards.

    On a mesh (``ctx``), under head-TP in every mode, the input passes
    ``copy_to_model`` and the rank computes its query heads (and their K/V
    heads) only, the output projection row-parallel; a cache holds the
    rank's K/V heads.  Under context parallelism (train mode only) x holds
    the rank's rows, which ``positions`` place in the sequence, and K/V are
    all-gathered over ``model``, so the kernels see the rank's S/tp query
    rows against all T keys at ``q_offset`` = its first row."""
    if mode not in ("train", "prefill", "decode", "chunk"):
        raise ValueError(f"unknown attention mode {mode!r}")
    window = cfg.sliding_window if window is None else window
    if mode == "decode" and cache is not None and "len" in cache:
        # cross-attention: K/V were projected once, at prefill
        o = ops.decode_attention(_project_q(cfg, params, x), cache["k"], cache["v"],
                                 cache["len"], softcap=cfg.attn_logit_softcap,
                                 impl=cfg.kernel_impl)
        return _out_proj(cfg, params, o), cache
    if cross_kv is not None:
        if mode not in ("train", "prefill"):
            raise ValueError(f"cross-attention over an encoder output runs in train or prefill "
                             f"mode, not {mode!r}; a decode step reads the cross cache")
        q, k, v = _project_qkv(cfg, params, x, cross_kv)
        o = ops.attention(q, k, v, causal=False, window=window,
                          softcap=cfg.attn_logit_softcap, impl=cfg.kernel_impl)
        lengths = torch.full((x.shape[0],), k.shape[1], dtype=torch.int32, device=x.device)
        return _out_proj(cfg, params, o), ({"k": k, "v": v, "len": lengths}
                                           if mode == "prefill" else None)
    causal = cfg.causal if causal is None else causal
    head_tp = ctx is not None and ctx.head_tp
    seq_par = ctx is not None and ctx.seq_parallel
    if seq_par and mode != "train":
        raise NotImplementedError(
            f"{cfg.name}: {mode} under context parallelism is not ported yet (ROADMAP: item "
            "14e, the sequence-sharded cache); serve with heads that divide over model")
    if head_tp:
        x = ctx.copy_to_model(x)
    q, k, v = _project_qkv(cfg, params, x)
    if head_tp:
        k, v = _tp_kv(cfg, ctx, k, v)
    tp_ctx = ctx if head_tp else None
    q_offset = ctx.coords["model"] * x.shape[1] if seq_par else 0
    if seq_par and positions is None:
        positions = q_offset + torch.arange(x.shape[1], device=x.device)
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
            # the insert runs inside the decode kernel: (page_idx, row)
            # address position lengths - 1 (paged_decode_addressing)
            o = ops.paged_decode_append(q, k_pool, v_pool, k, v, paged["block_table"],
                                        paged["lengths"], paged["page_idx"], paged["row"],
                                        softcap=cfg.attn_logit_softcap, impl=cfg.kernel_impl)
        return _out_proj(cfg, params, o, tp_ctx), cache

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
        return _out_proj(cfg, params, o, tp_ctx), cache

    if seq_par:
        k, v = ctx.gather_seq(k), ctx.gather_seq(v)
    o = ops.attention(q, k, v, causal=causal, window=window, softcap=cfg.attn_logit_softcap,
                      q_offset=q_offset, impl=cfg.kernel_impl)
    out = _out_proj(cfg, params, o, tp_ctx)
    return out, ({"k": k, "v": v} if mode == "prefill" else None)


def cache_shape(cfg: ModelConfig, batch: int, max_len: int,
                kv_heads: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(batch, T, Hkv, D) of a dense cache; T = min(max_len, window) for a
    sliding-window model (a rolling cache).  ``kv_heads``: the K/V heads
    a head-TP rank caches (``rank_kv_heads``; default all of them)."""
    T = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return (batch, T, kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim)


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, dtype: torch.dtype,
                     device: torch.device, stack: Tuple[int, ...] = (),
                     kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Zeroed K/V page pools, {"k_pool", "v_pool"} of shape (*stack,
    num_pages, page_size, Hkv, D); the stack builds all layers' pools at
    once with ``stack=(num_layers,)``; Hkv is ``kv_heads`` (a head-TP
    rank's, default all).  The block table lives at the engine cache's top
    level: it is the same for every layer and every rank.  Raises for a
    sliding-window model: the paged layout has no rolling cache."""
    if cfg.sliding_window:
        raise ValueError(
            "cache_layout='paged' does not support sliding-window (rolling) "
            "caches — use the dense layout"
        )
    shape = (*stack, num_pages, page_size, kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim)
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
