"""Mixture-of-Experts FFN: sort-by-expert ragged dispatch (the port of the
reference's ``models/moe.py``, single device).

Routing (fp32, see ``_route``) -> stable sort of the ``T·K`` (token,
choice) slots by expert -> capacity truncation (dropped slots are re-keyed
past every real expert, so the second stable sort moves them beyond
``sum(group_sizes)``, where the grouped matmul returns zeros and spends no
compute) -> per-expert GEMMs through ``ops.grouped_matmul`` (the ragged
kernel on the card) -> unsort and combine in fp32.  No dense ``(T, E)``
dispatch tensor is built.

Capacity and drops: ``C = capacity(cfg, T)`` per call, over the T = B·S
rows of that call; within an expert, slots keep their token order (stable
sorts), so earlier tokens win capacity.  A dropped slot contributes
nothing and the residual stream carries its token through unchanged.  In
serving, idle decode slots route too and take capacity, as in the
reference.

Everything stays on the device: the sizes come from a scatter-add, not
``bincount``, no mask indexing, no ``.item()``, so a decode step makes no
host sync here.  The combine gathers each token's K rows through the
inverse permutation and sums them in a fixed order, where the reference's
scatter-add would be float atomics on the card: a step repeats bit for bit.
In the backward the only scatters are the two ``index_select``s' (index
adds); the combine's indices are a permutation, and with top-1 routing
(Scout, Maverick) so are the dispatch's.  Top-k > 1 repeats each token's
index K times in the dispatch, so its backward adds with atomics in an
order that changes from run to run, and a repeated step may then differ in
its last bits.

Aux channel: ``moe_apply`` returns a fixed-shape fp32 vector
(``aux_shape(cfg)``), summed over layers by the stack: ``[load-balance
loss, entropy deficit, dropped slots, total slots, per-expert kept-load
fractions…]``.  The first two carry the router's gradient, as in the
reference; the statistics after them are detached.  ``Model.loss_fn`` adds
the two router loss terms and reads the statistics into its metrics;
serving drops the vector.  The reference's expert-parallel path
(``_moe_expert_parallel``) comes with the multi-GPU slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import P
from repro_torch.kernels import ops
from repro_torch.models.layers import _act, mlp_apply, mlp_defs

AUX_BASE = 4  # [lb_loss, entropy_deficit, dropped_slots, total_slots]


def aux_shape(cfg: ModelConfig) -> Tuple[int, ...]:
    """Shape of the per-layer aux vector summed over the stack: ``()`` for
    dense models, ``(AUX_BASE + E,)`` for MoE models."""
    return (AUX_BASE + cfg.num_experts,) if cfg.num_experts else ()


def moe_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    defs: Dict[str, Any] = {
        "router": P((d, e), (None, None), init="normal", scale=0.02),
        "w_in": P((e, d, f), ("experts", "fsdp", None), fan_in=d),
        "w_out": P((e, f, d), ("experts", None, "fsdp"), fan_in=f),
    }
    if cfg.act in ("swiglu", "geglu"):
        defs["w_gate"] = P((e, d, f), ("experts", "fsdp", None), fan_in=d)
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(cfg, d, cfg.d_ff * cfg.n_shared_experts)
    return defs


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.num_experts_per_tok / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)  # padded to 8, as in the reference


def _route(cfg: ModelConfig, params: Dict[str, Any], x2d: torch.Tensor):
    """fp32 routing -> (probs (T, E), renormalized top-k gates (T, K),
    expert indices (T, K) int64).  Top-k is a stable descending sort, so
    equal probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no tie order)."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    gate, idx = vals[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, idx


def _expert_ffn_ragged(cfg: ModelConfig, params: Dict[str, Any], xs: torch.Tensor,
                       sizes: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Per-expert FFN over the sorted rows through the ragged grouped
    matmul; each product is rounded to the compute dtype, as is the
    activation."""

    def gmm(a, w):
        return ops.grouped_matmul(a, w.to(cdt), sizes, impl=cfg.kernel_impl)

    h = gmm(xs, params["w_in"])
    if "w_gate" in params:
        h = _act(cfg.act, gmm(xs, params["w_gate"])) * h
    else:
        h = _act(cfg.act, h)
    return gmm(h, params["w_out"])


def _moe_ragged(cfg: ModelConfig, params: Dict[str, Any], xf: torch.Tensor,
                flat_e: torch.Tensor, keep: torch.Tensor, gates: torch.Tensor,
                cdt: torch.dtype) -> torch.Tensor:
    """Sort by expert -> ragged FFN -> unsort and combine -> (T, d) fp32.

    Dropped slots are keyed to the virtual expert E, so the stable sort
    moves them past ``sum(sizes)``, the kernel's zero tail."""
    T, d = xf.shape
    M = flat_e.shape[0]
    K, E = cfg.num_experts_per_tok, cfg.num_experts
    key = torch.where(keep, flat_e, E)
    order = torch.argsort(key, stable=True)          # token order kept within an expert
    xs = xf.index_select(0, order // K)              # (M, d) rows sorted by expert
    ones = torch.ones((M,), dtype=torch.int32, device=xf.device)
    sizes = torch.zeros((E + 1,), dtype=torch.int32, device=xf.device)
    sizes = sizes.scatter_add_(0, key, ones)[:E]     # the dropped bin E left out
    ys = _expert_ffn_ragged(cfg, params, xs, sizes, cdt)
    # slot s sits at sorted row inv[s]; a token's K slots are rows t·K..t·K+K-1
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(M, device=xf.device))
    y = (ys.index_select(0, inv).float() * gates[:, None]).reshape(T, K, d)
    out = y[:, 0]
    for k in range(1, K):
        out = out + y[:, k]
    return out


def moe_apply(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x.dtype, aux (AUX_BASE + E,) fp32 —
    see the module doc)."""
    B, S, d = x.shape
    cdt = x.dtype
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    M = T * K
    C = capacity(cfg, T)
    xf = x.reshape(T, d)
    dev = x.device

    probs, gate, idx = _route(cfg, params, xf)

    # load-balance aux loss (Switch/GShard form) and router entropy deficit
    me = probs.mean(dim=0)                                            # (E,)
    ce = (idx[:, :1] == torch.arange(E, device=dev)).float().mean(dim=0)
    lb = E * (me * ce).sum()
    ent = -(probs * torch.log(probs + 1e-9)).sum(-1).mean()
    ent_def = math.log(float(E)) - ent

    # capacity: the rank of each slot within its expert (stable sort: token
    # order); slots at rank >= C are dropped
    flat_e = idx.reshape(M)                                           # slot s = t·K + k
    counts = torch.zeros((E,), dtype=torch.int32, device=dev).scatter_add_(
        0, flat_e, torch.ones((M,), dtype=torch.int32, device=dev))
    starts = torch.cumsum(counts, 0) - counts
    order0 = torch.argsort(flat_e, stable=True)
    rank_sorted = torch.arange(M, device=dev) - starts[flat_e[order0]]
    keep = torch.zeros((M,), dtype=torch.bool, device=dev).scatter_(0, order0, rank_sorted < C)
    gates = gate.reshape(M) * keep.float()

    out = _moe_ragged(cfg, params, xf, flat_e, keep, gates, cdt).to(cdt).reshape(B, S, d)
    if "shared" in params:
        out = out + mlp_apply(cfg, params["shared"], x)

    kept = counts.clamp_max(C).float()                                # (E,)
    load = kept / kept.sum().clamp_min(1.0)
    dropped = M - kept.sum()
    stats = torch.cat([torch.stack([dropped, torch.full_like(dropped, M)]), load]).detach()
    return out, torch.cat([torch.stack([lb, ent_def]), stats])


def moe_ref_dense(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Oracle: every token to its top-k experts with no capacity limit, in
    fp32 (tests only)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d).float()
    probs = torch.softmax(xt @ params["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    gate, idx = vals[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    w_in, w_out = params["w_in"].float(), params["w_out"].float()
    w_gate = params.get("w_gate")
    out = torch.zeros_like(xt)
    for j in range(k):
        e = idx[:, j]
        h = torch.einsum("td,tdf->tf", xt, w_in[e])
        if w_gate is not None:
            h = _act(cfg.act, torch.einsum("td,tdf->tf", xt, w_gate.float()[e])) * h
        else:
            h = _act(cfg.act, h)
        out = out + gate[:, j:j + 1] * torch.einsum("tf,tfd->td", h, w_out[e])
    return out.reshape(B, S, d).to(x.dtype)
