"""GQA self-attention: projections with optional biases, RoPE, and the
attention ops, for the full-sequence ``train`` / ``prefill`` modes and the
one-token ``decode`` mode over a dense KV cache.

Cache layout: {"k": (B, T, Hkv, D), "v": (B, T, Hkv, D)}, the reference's.
A decode step writes the new token's K/V into the cache in place — one
indexed write of B rows, where the reference's per-slot path selects over
the whole (B, T) buffer; the same values land in the same places — and
returns the same tensors.  Sliding-window caches are rolling: the write
goes to ``pos % T``.

The paged layout, the chunked-prefill mode and cross-attention come with
later slices (ROADMAP); they raise here.
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
    mode: str = "train",                  # train | prefill | decode
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Union[None, int, torch.Tensor] = None,   # int, or (B,) per slot
    causal: Optional[bool] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out (B,S,d_model), cache): {"k", "v"} of this call's rows in
    prefill mode, the updated cache in decode mode, None in train mode.

    Decode: ``cache_pos`` is the write position — an int for lockstep rows
    (every row at the same position) or a (B,) tensor for per-slot
    positions (the serving engine); row b then attends over its first
    min(pos_b + 1, T) cache rows."""
    if mode not in ("train", "prefill", "decode") or (
            cache is not None and ("k_pool" in cache or "len" in cache)):
        raise NotImplementedError(
            f"attention mode {mode!r} with this cache is not ported yet "
            f"(ROADMAP: paged layout, chunked prefill and cross-attention slices)"
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

