"""GQA self-attention: projections with optional biases, RoPE, and the
flash-attention op, for the full-sequence ``train`` / ``prefill`` modes.

Decode, paged and chunked-prefill modes and cross-attention come with the
generation slice (ROADMAP: port queue); they raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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
    mode: str = "train",                  # train | prefill
    causal: Optional[bool] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out (B,S,d_model), cache): cache is {"k", "v"} in prefill
    mode and None in train mode."""
    if mode not in ("train", "prefill"):
        raise NotImplementedError(
            f"attention mode {mode!r} is not ported yet (ROADMAP: generation slice)"
        )
    causal = cfg.causal if causal is None else causal
    window = cfg.sliding_window if window is None else window
    q, k, v = _project_qkv(cfg, params, x)
    if cfg.use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = ops.attention(q, k, v, causal=causal, window=window,
                      softcap=cfg.attn_logit_softcap, impl=cfg.kernel_impl)
    out = _out_proj(cfg, params, o)
    return out, ({"k": k, "v": v} if mode == "prefill" else None)
