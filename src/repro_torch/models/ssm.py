"""Mamba-2 (SSD) block: in_proj → causal depthwise conv → SSD scan → gated
norm → out_proj, and the single-step recurrent path for decoding.

The port's twin of the reference's ``repro.models.ssm``: the same param
tree, the same modes and the same numerics — the conv in fp32, cast to the
compute dtype after its SiLU; dt = softplus(dt_raw + dt_bias) in fp32; the
gate y · silu(z) before an RMSNorm over each SSD head's channels.  The
prefill's scan is ``ops.ssd`` (the SSD kernel on the card); the decode step
is ``ops.ssd_decode_step`` (plain PyTorch).  At decode the conv buffer and
the state are advanced in place in the cache the engine holds, where the
reference returns new arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import P
from repro_torch.kernels import ops


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    nh = cfg.ssm_nheads
    ng, ns = cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = di + 2 * ng * ns
    in_dim = 2 * di + 2 * ng * ns + nh        # z, x, B, C, dt
    return di, nh, ng, ns, conv_dim, in_dim


def ssm_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    di, nh, ng, ns, conv_dim, in_dim = _dims(cfg)
    return {
        "w_in": P((d, in_dim), ("fsdp", "tp"), fan_in=d),
        "conv_w": P((cfg.ssm_conv, conv_dim), (None, "tp"), init="normal", scale=0.1),
        "conv_b": P((conv_dim,), ("tp",), init="zeros"),
        "A": P((nh,), ("tp",), init="ssm_a"),
        "D": P((nh,), ("tp",), init="ones"),
        "dt_bias": P((nh,), ("tp",), init="ssm_dt_bias"),
        "norm_scale": P((di,), ("tp",), init="ones"),
        "w_out": P((di, d), ("tp", "fsdp"), fan_in=di),
    }


def _split_in(cfg: ModelConfig, h: torch.Tensor):
    di, _, _, _, conv_dim, _ = _dims(cfg)
    return h[..., :di], h[..., di:di + conv_dim], h[..., di + conv_dim:]


def _grouped_rmsnorm(x: torch.Tensor, scale: torch.Tensor, nheads: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over each SSD head's channels, in fp32, output in x.dtype."""
    B, S, di = x.shape
    xg = x.reshape(B, S, nheads, di // nheads).float()
    var = (xg * xg).mean(dim=-1, keepdim=True)
    y = xg * torch.rsqrt(var + eps)
    return (y.reshape(B, S, di) * scale.float()).to(x.dtype)


def ssm_apply(
    cfg: ModelConfig,
    params: Dict[str, Any],
    x: torch.Tensor,                   # (B, S, d_model)
    *,
    mode: str = "train",
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out (B, S, d_model), cache).  ``train``: no cache.
    ``prefill``: a new cache, ``conv`` the last kw−1 pre-conv inputs
    (zero-padded for a prompt shorter than that) in the compute dtype and
    ``state`` the scan's final state in fp32.  ``decode`` (S = 1): the
    ``cache`` given — ``conv`` (B, kw−1, conv_dim) and ``state`` (B, H, P,
    N) fp32 — advanced in place and returned."""
    B, S, _ = x.shape
    cdt = x.dtype
    di, nh, ng, ns, conv_dim, _ = _dims(cfg)
    kw = cfg.ssm_conv

    h = x @ params["w_in"].to(cdt)                 # (B, S, in_dim)
    z, xbc, dt_raw = _split_in(cfg, h)
    conv_w, conv_b = params["conv_w"].float(), params["conv_b"].float()

    if mode == "decode":
        if cache is None:
            raise ValueError("decode mode needs the SSM cache")
        conv_buf = cache["conv"]
        window = torch.cat([conv_buf, xbc.to(conv_buf.dtype)], dim=1)       # (B, kw, conv)
        conv_out = torch.einsum("bkc,kc->bc", window.float(), conv_w) + conv_b
        conv_out = F.silu(conv_out)[:, None].to(cdt)                        # (B, 1, conv)
        conv_buf.copy_(window[:, 1:])
    else:
        # causal depthwise conv over the sequence
        xp = torch.cat([xbc.new_zeros((B, kw - 1, conv_dim)), xbc], dim=1)  # (B, S+kw-1, conv)
        conv_out = sum(xp[:, i:i + S].float() * conv_w[i] for i in range(kw))
        conv_out = F.silu(conv_out + conv_b).to(cdt)
        new_conv = xp[:, S:]                                                # the last kw-1 inputs

    xs = conv_out[..., :di].unflatten(-1, (nh, di // nh))                   # (B, S, H, P)
    Bm = conv_out[..., di:di + ng * ns].unflatten(-1, (ng, ns))
    Cm = conv_out[..., di + ng * ns:].unflatten(-1, (ng, ns))
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())             # (B, S, H)

    if mode == "decode":
        y, _ = ops.ssd_decode_step(xs, dt, params["A"], Bm, Cm, params["D"], cache["state"],
                                   impl=cfg.kernel_impl)
        new_cache = cache
    else:
        y, final_state = ops.ssd(xs, dt, params["A"], Bm, Cm, params["D"], chunk=cfg.ssm_chunk,
                                 impl=cfg.kernel_impl)
        new_cache = ({"conv": new_conv.to(cdt), "state": final_state.float()}
                     if mode == "prefill" else None)

    y = y.reshape(B, -1, di)
    y = y * F.silu(z.float()).to(cdt)                                      # gate
    y = _grouped_rmsnorm(y, params["norm_scale"], nh)
    return y @ params["w_out"].to(cdt), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, device: torch.device,
                   *, stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache: ``conv`` (*stack, batch, kw−1, conv_dim) in
    ``dtype`` and ``state`` (*stack, batch, H, P, N) in fp32."""
    di, nh, _, ns, conv_dim, _ = _dims(cfg)
    return {
        "conv": torch.zeros((*stack, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((*stack, batch, nh, di // nh, ns), dtype=torch.float32,
                             device=device),
    }
