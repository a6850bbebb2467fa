"""The dense pre-norm transformer stack.

Params keep the reference's tree: one ``sub0`` unit per layer, each leaf
stacked over the layers (leading dim ``num_layers``).  The stack runs as a
plain loop over the layers, each stacked leaf unbound into per-layer views
once per call (no copy).
The scan-unit machinery the reference needs for MoE periods and hybrid
interleaves is not ported yet: those configs raise.  The same loop runs
under autograd for training.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import stack_tree, tree_map
from repro_torch.models import layers as L
from repro_torch.models.attention import (
    attention_apply,
    attention_defs,
    cache_shape,
    init_paged_cache,
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the architectures the port does not run yet."""
    unported = [
        (cfg.num_experts > 0, "MoE layers (ROADMAP: MoE slice, grouped matmul)"),
        (cfg.family in ("ssm", "hybrid"), "SSM / hybrid stacks (ROADMAP: SSM slice, SSD scan)"),
        (cfg.is_encoder_decoder or bool(cfg.frontend),
         "encoder-decoder and frontend models (ROADMAP: enc-dec/frontend slice)"),
        (cfg.parallel_residual, "parallel_residual blocks (ROADMAP: port queue, dense stack)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"{cfg.name}: {what} are not ported yet")


def _layer_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    defs: Dict[str, Any] = {"norm1": L.norm_defs(cfg, d), "attn": attention_defs(cfg)}
    if cfg.d_ff > 0:
        defs["norm2"] = L.norm_defs(cfg, d)
        defs["ffn"] = L.mlp_defs(cfg, d, cfg.d_ff)
    return defs


def stack_defs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    return stack_tree({"sub0": _layer_defs(cfg)}, cfg.num_layers)


def _apply_layer(cfg, params, x, *, mode, positions, causal, cache, cache_pos, paged):
    h = L.norm_apply(cfg, params["norm1"], x)
    mix, cache = attention_apply(cfg, params["attn"], h, positions=positions, mode=mode,
                                 causal=causal, cache=cache, cache_pos=cache_pos,
                                 paged=paged)
    x = x + mix
    if "ffn" in params:
        x = x + L.mlp_apply(cfg, params["ffn"], L.norm_apply(cfg, params["norm2"], x))
    return x, cache


def decoder_stack(
    cfg: ModelConfig,
    stacked_params: Dict[str, Any],
    x: torch.Tensor,
    *,
    mode: str = "train",
    positions: Optional[torch.Tensor] = None,
    caches: Optional[Dict[str, Any]] = None,
    cache_pos: Union[None, int, torch.Tensor] = None,
    causal: Optional[bool] = None,
    paged: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Runs every layer.  Returns (x, caches), caches in the reference's
    stacked tree ``{"sub0": {"attn": {...}}}``: in prefill mode this call's
    K/V, leaves ``k``/``v`` (num_layers, B, T, Hkv, D); in decode and chunk
    modes the ``caches`` passed in — dense ``k``/``v`` or paged
    ``k_pool``/``v_pool`` (num_layers, P, page, Hkv, D) — updated in place
    (each layer writes through its view of the stacked buffers); None in
    train mode.  ``paged``, the paged layout's addresses of this step or
    chunk (``attention.paged_*_addressing``), reaches every layer."""
    check_supported(cfg)
    # one unbind per stacked leaf: under autograd its backward stacks the
    # per-layer grads once, where slicing p[j] per layer would write a
    # zero-filled copy of the whole stacked leaf for each layer
    per_layer = tree_map(lambda p: p.unbind(0), stacked_params["sub0"])
    in_place = mode in ("decode", "chunk")
    per_cache = tree_map(lambda c: c.unbind(0), caches["sub0"]) if in_place else None
    new = []
    for j in range(cfg.num_layers):
        layer = tree_map(lambda ps: ps[j], per_layer)
        cache = tree_map(lambda cs: cs[j], per_cache["attn"]) if per_cache else None
        x, cache = _apply_layer(cfg, layer, x, mode=mode, positions=positions, causal=causal,
                                cache=cache, cache_pos=cache_pos, paged=paged)
        new.append(cache)
    if in_place:
        return x, caches
    if mode == "prefill":
        return x, {"sub0": {"attn": {n: torch.stack([c[n] for c in new]) for n in ("k", "v")}}}
    return x, None


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                     device: torch.device, *, layout: str = "dense", page_size: int = 0,
                     num_pages: int = 0) -> Dict[str, Any]:
    """The decode cache, stacked over the layers, zeroed (the reference
    builds one layer's cache and broadcasts it).  Dense: leaves ``k``/``v``
    (num_layers, batch, T, Hkv, D).  Paged: leaves ``k_pool``/``v_pool``
    (num_layers, num_pages, page_size, Hkv, D), shared by every slot; each
    layer works on a contiguous view."""
    if layout == "paged":
        return {"sub0": {"attn": init_paged_cache(cfg, num_pages, page_size, dtype, device,
                                                  stack=(cfg.num_layers,))}}
    shape = (cfg.num_layers, *cache_shape(cfg, batch, max_len))
    return {"sub0": {"attn": {n: torch.zeros(shape, dtype=dtype, device=device)
                              for n in ("k", "v")}}}
