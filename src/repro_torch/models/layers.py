"""Shared layers: norms, rotary embeddings, MLPs, embeddings.

Every layer is a pair: ``*_defs`` returns a P-tree, ``*_apply`` is a plain
function of (config, params dict, activations).  Weights keep the
reference's ``x @ W`` layout; each is cast to the activation dtype where it
enters a matmul.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import P
from repro_torch.kernels import ops


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def norm_defs(cfg: ModelConfig, d: int) -> Dict[str, P]:
    defs = {"scale": P((d,), (None,), init="ones")}
    if cfg.norm_type == "layernorm":
        defs["bias"] = P((d,), (None,), init="zeros")
    return defs


def norm_apply(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm (eps 1e-5) in fp32, output in x.dtype.  The
    reference calls its norms without ``impl=``; the port passes
    ``cfg.kernel_impl``, which gives the same results."""
    if cfg.norm_type == "rmsnorm":
        return ops.rmsnorm(x, params["scale"], impl=cfg.kernel_impl)
    return ops.layernorm(x, params["scale"], params.get("bias"), impl=cfg.kernel_impl)


# --------------------------------------------------------------------- #
# rotary position embedding
# --------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S).  Half-split rotation in
    fp32, cast back to x.dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None]
    ang = (pos[:, :, None] * freqs)[:, :, None, :]     # (1|B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# dense MLP
# --------------------------------------------------------------------- #
def mlp_defs(cfg: ModelConfig, d: int, d_ff: int) -> Dict[str, P]:
    defs: Dict[str, P] = {
        "w_in": P((d, d_ff), ("fsdp", "tp"), fan_in=d),
        "w_out": P((d_ff, d), ("tp", "fsdp"), fan_in=d_ff),
    }
    if cfg.act in ("swiglu", "geglu"):
        defs["w_gate"] = P((d, d_ff), ("fsdp", "tp"), fan_in=d)
    if cfg.mlp_bias:
        defs["b_in"] = P((d_ff,), ("tp",), init="zeros")
        defs["b_out"] = P((d,), (None,), init="zeros")
    return defs


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "swiglu":
        return F.silu(x)
    if name in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return F.relu(x)


def mlp_apply(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor,
              ctx: Any = None) -> torch.Tensor:
    """Under head-TP (``ctx.head_tp`` and d_ff dividing over ``model``) the
    weights are this rank's slice of d_ff: ``w_in`` and ``w_gate``
    column-parallel, ``w_out`` row-parallel with one all-reduce over
    ``model``, and ``b_out`` added once, after it."""
    cdt = x.dtype
    tp = ctx is not None and ctx.head_tp and cfg.d_ff % ctx.tp == 0
    if tp:
        x = ctx.copy_to_model(x)
    h = x @ params["w_in"].to(cdt)
    if "b_in" in params:
        h = h + params["b_in"].to(cdt)
    if "w_gate" in params:
        h = _act(cfg.act, x @ params["w_gate"].to(cdt)) * h
    else:
        h = _act(cfg.act, h)
    out = h @ params["w_out"].to(cdt)
    if tp:
        out = ctx.reduce_from_model(out)
    if "b_out" in params:
        out = out + params["b_out"].to(cdt)
    return out


# --------------------------------------------------------------------- #
# embeddings
# --------------------------------------------------------------------- #
def embedding_defs(cfg: ModelConfig) -> Dict[str, P]:
    defs = {
        "tok": P((cfg.padded_vocab, cfg.d_model), ("tp", "fsdp"), init="normal", scale=0.02)
    }
    if not cfg.use_rope and cfg.max_pos:
        defs["pos"] = P((cfg.max_pos, cfg.d_model), (None, "fsdp"), init="normal", scale=0.02)
    return defs


class _Lookup(torch.autograd.Function):
    """Row gather whose backward is a one-hot matmul, the same bits on every
    run: the scatter-add that indexing's backward runs instead accumulates
    repeated tokens in an order that changes from run to run (atomics on
    the GPU, threads on the CPU), and a train step must be repeatable.
    The matmul costs 2·tokens·rows·d FLOP: small at ESM-2's 256 rows."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        onehot = (flat[:, None] == torch.arange(ctx.rows, device=flat.device)).to(dy.dtype)
        return onehot.T @ dy.reshape(flat.shape[0], -1), None


def embed_apply(
    cfg: ModelConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,            # (B, S) integer
    positions: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Table lookup in the stored dtype, then a cast to the compute dtype.
    A model with learned positions (``pos``: ``use_rope=False`` and
    ``max_pos``) adds the table's rows at ``positions``: 0..S-1 when None,
    else an (S,) vector shared by the batch or (B, S) rows, as the
    reference's ``embed_apply`` takes them.  A position past the table (a
    bucket's pad row) reads its last row, where the reference's ``take``
    fills NaN; neither reaches a real row.  Other models ignore
    ``positions``."""
    x = _Lookup.apply(params["tok"], tokens.long()).to(compute_dtype)
    if "pos" in params:
        table = params["pos"]
        if positions is None:
            pe = table[: tokens.shape[1]][None]
        else:
            pe = table[positions.long().clamp(0, table.shape[0] - 1)]
            pe = pe if pe.dim() == 3 else pe[None]
        x = x + pe.to(compute_dtype)
    return x


def lm_head_defs(cfg: ModelConfig) -> Dict[str, P]:
    """Empty for tied embeddings: the LM head reuses ``embed/tok``."""
    if cfg.tie_embeddings:
        return {}
    return {"w": P((cfg.d_model, cfg.padded_vocab), ("fsdp", "tp"), fan_in=cfg.d_model)}


def lm_head_weight(cfg: ModelConfig, params: Dict[str, Any], embed_params: Dict[str, Any]
                   ) -> torch.Tensor:
    """The (d_model, Vpad) output weight; the tied head is the transposed
    view ``embed/tok.T``, no copy."""
    if cfg.tie_embeddings:
        return embed_params["tok"].T
    return params["w"]
