"""Dispatch of the port's hot-path ops.

``impl="auto"`` (the default, and ``ModelConfig.kernel_impl``'s) hands the
tensors to the kernel wrapper: a CUDA tensor launches the hand-written
kernel — a failed launch raises, nothing falls back — and a CPU tensor
runs the plain PyTorch version.  ``impl="torch"`` runs the plain version on
any device; only the tests and ``chip_smoke.py`` use it, to hold the
kernels against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import layernorm as _layernorm_kernel

IMPLS = ("auto", "torch")


def _plain(impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of {IMPLS}")
    return impl == "torch"


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,Hkv,D) -> (B,S,H,D) in q.dtype."""
    fn = ref.attention_ref if _plain(impl) else flash_attention_fwd
    out, _ = fn(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    return out


def layernorm(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    fn = ref.layernorm_ref if _plain(impl) else _layernorm_kernel
    return fn(x, w, b, eps)
