"""The pre-norm decoder stack: attention or Mamba-2 (SSD) mixers, each with
a dense or MoE FFN (or none).

Layers are grouped into *units*, as in the reference: the unit is
``attn_layer_period`` layers for a hybrid (Jamba: seven SSD layers and one
attention layer, mid-unit), ``moe_layer_period`` layers for an MoE model
(Llama-4 Maverick: a dense layer, then an MoE layer), one layer
otherwise.  Params keep the reference's tree: ``{"sub0": …, "sub1": …}``,
one entry per layer of the unit, each leaf stacked over the units
(leading dim ``num_units``).  The stack runs as a plain loop over the
units and, inside one, over its layers; each stacked leaf is unbound into
per-unit views once per call (no copy).  The same loop runs under
autograd for training.  A parallel-residual block (Command-R) feeds
norm1's output to both the mixer and the FFN and adds both to the
residual, in every mode.

An encoder-decoder's decoder layers (``cross``) add a cross-attention
sublayer after the mixer: ``norm_x``, then attention over the encoder
output (``cross_kv``) added to the residual.  In prefill mode it returns
the layer's write-once cross cache ``{"xattn": {"k", "v", "len"}}`` beside
its K/V; a decode step reads it.  The encoder is this same stack over the
encoder's config (``model.encoder_config``), run in train mode without a
causal mask.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import stack_tree, tree_map
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.attention import (
    attention_apply,
    attention_defs,
    cache_shape,
    init_paged_cache,
)
from repro_torch.models.ssm import init_ssm_cache, ssm_apply, ssm_defs


FRONTENDS = ("", "audio_stub", "vision_stub")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a frontend the reference does not know (the port runs
    every other architecture of the zoo)."""
    if cfg.frontend not in FRONTENDS:
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not ported yet (the reference knows "
            f"{FRONTENDS[1:]})")


# --------------------------------------------------------------------- #
# unit structure
# --------------------------------------------------------------------- #
def unit_size(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.attn_layer_period
    if cfg.num_experts and cfg.moe_layer_period > 1:
        return cfg.moe_layer_period
    return 1


def num_units(cfg: ModelConfig) -> int:
    u = unit_size(cfg)
    if cfg.num_layers % u:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a whole number of "
                         f"units of {u}")
    return cfg.num_layers // u


def num_moe_layers(cfg: ModelConfig) -> int:
    """Total MoE layers in the stack (normalizes summed aux statistics)."""
    if not cfg.num_experts:
        return 0
    return sum(1 for i in range(unit_size(cfg)) if cfg.is_moe_layer(i)) * num_units(cfg)


def _sublayer_defs(cfg: ModelConfig, li: int, cross: bool) -> Dict[str, Any]:
    """Param defs of layer ``li`` of a unit; ``cross`` adds the
    cross-attention sublayer."""
    d = cfg.d_model
    defs: Dict[str, Any] = {"norm1": L.norm_defs(cfg, d)}
    if cfg.is_attn_layer(li):
        defs["attn"] = attention_defs(cfg)
    else:
        defs["ssm"] = ssm_defs(cfg)
    if cross:
        defs["norm_x"] = L.norm_defs(cfg, d)
        defs["xattn"] = attention_defs(cfg, cross=True)
    if cfg.d_ff > 0:
        if not cfg.parallel_residual:       # a parallel block's FFN reads norm1's output
            defs["norm2"] = L.norm_defs(cfg, d)
        defs["ffn"] = moe.moe_defs(cfg) if cfg.is_moe_layer(li) else L.mlp_defs(cfg, d, cfg.d_ff)
    return defs


def stack_defs(cfg: ModelConfig, cross: bool = False) -> Dict[str, Any]:
    check_supported(cfg)
    return stack_tree({f"sub{i}": _sublayer_defs(cfg, i, cross) for i in range(unit_size(cfg))},
                      num_units(cfg))


def _apply_sublayer(cfg, li, params, x, *, mode, positions, causal, cache, cache_pos, paged,
                    cross_kv, ctx):
    """Returns (x, cache, aux): cache is the layer's ``{"attn": …}`` or
    ``{"ssm": …}``, with ``"xattn"`` beside it in a cross layer's prefill
    (None in train mode); aux is the MoE layer's router vector
    (``moe.aux_shape``), None for a dense layer."""
    h = L.norm_apply(cfg, params["norm1"], x)
    if "attn" in params:
        mix, c = attention_apply(cfg, params["attn"], h, positions=positions, mode=mode,
                                 causal=causal, cache=cache["attn"] if cache else None,
                                 cache_pos=cache_pos, paged=paged, ctx=ctx)
        kind = "attn"
    else:
        if mode == "chunk":
            raise ValueError("chunked prefill needs an attention-only stack: an SSM layer's "
                             "state cannot advance per chunk over bucket padding")
        mix, c = ssm_apply(cfg, params["ssm"], h, mode=mode, cache=cache["ssm"] if cache else None)
        kind = "ssm"
    cache_in, cache = cache, ({kind: c} if c is not None else None)
    if cfg.parallel_residual and "ffn" in params:   # the reference's order: (x + mix) + ff
        ff, aux = _ffn_apply(cfg, li, params["ffn"], h, ctx)
        return x + mix + ff, cache, aux
    x = x + mix
    if cross_kv is not None or (cache_in and "xattn" in cache_in):
        xmix, xc = attention_apply(cfg, params["xattn"], L.norm_apply(cfg, params["norm_x"], x),
                                   mode=mode, cross_kv=cross_kv,
                                   cache=cache_in["xattn"] if cache_in else None)
        x = x + xmix
        if xc is not None and mode == "prefill":
            cache["xattn"] = xc
    if "ffn" not in params:
        return x, cache, None
    ff, aux = _ffn_apply(cfg, li, params["ffn"], L.norm_apply(cfg, params["norm2"], x), ctx)
    return x + ff, cache, aux


def _ffn_apply(cfg, li, params, h, ctx):
    """(out, aux) of layer ``li``'s FFN: the MoE layer's router vector, or
    None for a dense MLP."""
    if cfg.is_moe_layer(li):
        return moe.moe_apply(cfg, params, h, ctx)
    return L.mlp_apply(cfg, params, h, ctx), None


def _unit_apply(x, aux_sum, *, cfg, layers, caches, **kw):
    """One unit: its layers in order (``layers`` and ``caches`` keyed
    ``sub<i>``).  Returns (x, aux_sum, caches): aux_sum with each MoE
    layer's router vector added in layer order, as the reference's carry."""
    out = {}
    for i, (s, layer) in enumerate(layers.items()):
        x, out[s], aux = _apply_sublayer(cfg, i, layer, x, cache=caches[s], **kw)
        if aux is not None:
            aux_sum = aux_sum + aux
    return x, aux_sum, out


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of the 2-D products, recompute everything else (the kernels
    reached through ctypes are not aten ops, so they run again, as the
    reference's ``pallas_call``s are not ``dot_general``s)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, policy: str):
    """``fn`` (a unit of the stack in train mode) under the reference's
    remat policies, through ``torch.utils.checkpoint`` (non-reentrant):
    ``block`` keeps only the unit's inputs and runs it again in the
    backward; ``dots`` keeps the outputs of ``aten.mm`` / ``aten.addmm``
    and runs the rest again; ``none`` and ``full`` return ``fn`` itself —
    the reference's ``everything_saveable`` keeps what no remat keeps, so
    the port runs such a unit unwrapped.  Every kernel of the stack is
    deterministic, so each policy gives ``none``'s loss and gradients bit
    for bit."""
    if policy in ("none", "full"):
        return fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=ctx)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)      # "block"


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
    cross_kv: Optional[torch.Tensor] = None,
    remat: str = "none",
    ctx: Any = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Runs every layer.  Returns (x, caches, aux_sum).  Caches are in the
    reference's stacked tree ``{"sub<i>": {"attn": {...}}}`` or
    ``{"sub<i>": {"ssm": {...}}}``, one entry per layer of the unit: in
    prefill mode this call's K/V, leaves ``k``/``v`` (num_units, B, T, Hkv,
    D), or SSM state, leaves ``conv`` (num_units, B, kw−1, conv_dim) and
    ``state`` (num_units, B, H, P, N); in decode and chunk modes the
    ``caches`` passed in — dense ``k``/``v`` or paged ``k_pool``/``v_pool``
    (num_units, P, page, Hkv, D), and ``conv``/``state`` — updated in place
    (each layer writes through its view of the stacked buffers); None in
    train mode.
    ``paged``, the paged layout's addresses of this step or chunk
    (``attention.paged_*_addressing``), reaches every layer.  ``cross_kv``,
    the encoder output, reaches every cross layer in train and prefill
    mode; prefill then returns each layer's ``xattn`` cache too (leaves
    ``k``/``v`` (num_units, B, T_enc, Hkv, D), ``len`` (num_units, B)),
    which decode mode reads from ``caches``.  ``aux_sum``
    is the MoE layers' router vectors summed (``moe.aux_shape``; a zero
    scalar for a dense model).  In train mode with autograd on, each unit
    runs under ``_remat_wrap(·, remat)``; anything else (``no_grad``, the
    other modes) runs it unwrapped.

    ``ctx`` (a ``parallel.sharding.ShardingCtx``) reaches every layer: on a
    mesh the layers run their collectives (head-TP's all-reduces in every
    mode, context parallelism's K/V gathers in train mode;
    ``models/attention.py``, ``models/layers.py``).  Under context parallelism x holds the rank's
    rows of the sequence, which ``positions`` place, and the norms see only
    those rows: their gradients are summed over ``model`` with the other
    leaves' (``ShardingCtx.reduce_axes``).  Under head-TP every ``model``
    rank holds the same rows after each all-reduce, so the norms' gradients
    are equal there and need no sum.  A remat unit reruns its forward
    collectives in the backward; every rank runs the same graph, so every
    rank reruns them in the same order."""
    check_supported(cfg)
    subs = [f"sub{i}" for i in range(unit_size(cfg))]
    # one unbind per stacked leaf: under autograd its backward stacks the
    # per-unit grads once, where slicing p[j] per unit would write a
    # zero-filled copy of the whole stacked leaf for each unit
    per_unit = {s: tree_map(lambda p: p.unbind(0), stacked_params[s]) for s in subs}
    in_place = mode in ("decode", "chunk")
    per_cache = ({s: tree_map(lambda c: c.unbind(0), caches[s]) for s in subs}
                 if in_place else None)
    kw = dict(cfg=cfg, mode=mode, positions=positions, causal=causal, cache_pos=cache_pos,
              paged=paged, cross_kv=cross_kv, ctx=ctx)
    train = mode == "train" and torch.is_grad_enabled()
    aux_sum = torch.zeros(moe.aux_shape(cfg), dtype=torch.float32, device=x.device)
    new = {s: [] for s in subs}
    for j in range(num_units(cfg)):
        layers = {s: tree_map(lambda ps: ps[j], per_unit[s]) for s in subs}
        unit_caches = ({s: tree_map(lambda cs: cs[j], per_cache[s]) for s in subs}
                       if per_cache else dict.fromkeys(subs))
        # bound with partial, not a closure over the loop: the backward may
        # run the unit again after the loop has moved on
        unit = functools.partial(_unit_apply, layers=layers, caches=unit_caches, **kw)
        x, aux_sum, unit_caches = _remat_wrap(unit, remat if train else "none")(x, aux_sum)
        for s in subs:
            new[s].append(unit_caches[s])
    if in_place:
        return x, caches, aux_sum
    if mode == "prefill":
        return x, {s: {kind: {n: torch.stack([c[kind][n] for c in new[s]]) for n in leaves}
                       for kind, leaves in new[s][0].items()}
                   for s in subs}, aux_sum
    return x, None, aux_sum


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                     device: torch.device, *, cross_len: int = 0, layout: str = "dense",
                     page_size: int = 0, num_pages: int = 0,
                     kv_heads: Optional[int] = None) -> Dict[str, Any]:
    """The decode cache, one entry per layer of the unit, each stacked over
    the units and zeroed (the reference builds one unit's cache and
    broadcasts it).  An attention layer's, dense: leaves ``k``/``v``
    (num_units, batch, T, Hkv, D); paged: leaves ``k_pool``/``v_pool``
    (num_units, num_pages, page_size, Hkv, D), shared by every slot.  An
    SSM layer's: ``conv`` and ``state`` per slot (``ssm.init_ssm_cache``);
    the engine refuses the paged layout for a stack that has one.  An
    encoder-decoder with ``cross_len`` > 0 adds each layer's dense
    ``xattn`` cache per slot in either layout: ``k``/``v`` (num_units,
    batch, cross_len, Hkv, D) and ``len`` (num_units, batch) int32 at
    cross_len.  Each layer works on a contiguous view.  ``kv_heads``: the
    K/V heads a head-TP rank's self-attention caches hold
    (``parallel.sharding.rank_kv_heads``; default all); the cross cache
    keeps every head (an encoder-decoder serves on a ``model`` axis of 1)."""
    n = num_units(cfg)

    def attn():
        if layout == "paged":
            return init_paged_cache(cfg, num_pages, page_size, dtype, device, stack=(n,),
                                    kv_heads=kv_heads)
        shape = (n, *cache_shape(cfg, batch, max_len, kv_heads))
        return {name: torch.zeros(shape, dtype=dtype, device=device) for name in ("k", "v")}

    def xattn():
        shape = (n, batch, cross_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "len": torch.full((n, batch), cross_len, dtype=torch.int32, device=device)}

    units = {f"sub{i}": ({"attn": attn()} if cfg.is_attn_layer(i) else
                         {"ssm": init_ssm_cache(cfg, batch, dtype, device, stack=(n,))})
             for i in range(unit_size(cfg))}
    if cfg.is_encoder_decoder and cross_len:
        for sub in units.values():
            sub["xattn"] = xattn()
    return units
