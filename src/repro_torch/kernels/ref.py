"""Plain PyTorch versions of the port's kernels.

Each function here is the semantic definition its kernel is held to: the
CPU path runs it, the CPU tests hold it against the reference package, and
``chip_smoke.py`` holds each kernel against it on the card.  Written for
clarity — attention materializes the full (B, H, S, T) fp32 score tensor.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,          # (B, S, H, D)
    k: torch.Tensor,          # (B, T, Hkv, D)
    v: torch.Tensor,          # (B, T, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,          # 0 = full
    softcap: float = 0.0,
    q_offset: int = 0,        # position of q[0] within the kv sequence
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: (out (B,S,H,D) in q.dtype, lse (B·H, S) fp32).

    Scores, softmax and the PV product are fp32, as in the reference's
    ``flash_attention_fwd``.  A row with no visible key gives output 0 and
    lse = -1e30, as that kernel does (the reference's textbook oracle
    instead spreads such a row uniformly)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    kf = k.float().repeat_interleave(group, dim=2)   # head h reads kv head h // group
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf) * (1.0 / math.sqrt(D))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(S, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhst,bthd->bshd", p, vf) / l.transpose(1, 2)
    lse = (m + torch.log(l)).reshape(B * H, S)
    return out.to(q.dtype), lse


def layernorm_ref(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, eps: float = 1e-5
) -> torch.Tensor:
    """Row LayerNorm over the last dim: fp32 moments, variance as
    mean((x-μ)²), optional bias, output in x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)
