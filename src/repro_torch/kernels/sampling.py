"""Fused sampling: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``fused_sample`` (``_sample_kernel``) of the
reference package: per-row temperature, top-k and top-p by dual
bisection, and Gumbel-max with the counter-hash (murmur3 fmix32) noise,
greedy rows returning the first-index argmax.  The kernel is
``csrc/sampling.cu`` (CUDA C++ for sm_90a, one block per row; its source
note gives the design and the bound).  The plain version is
``ref.sample_ref``; both compute the reference's ``_sample_rows`` row
math, and the noise is the same pure function of (seed, step, vocab id),
so a fixed-seed request draws the same tokens in any batch.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  ``fused_sample.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sample_ref


def _fn():
    fn = _build.load("sampling").fused_sample
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, ctypes.c_int64] + [p] * 7 + [p]
        fn.restype = i
    return fn


def _u32_bits(t: torch.Tensor) -> torch.Tensor:
    """An integer tensor as the int32 bit pattern of its value mod 2^32."""
    if t.dtype == torch.int32:
        return t.contiguous()
    u = t.long() & 0xFFFFFFFF
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def fused_sample(
    logits: torch.Tensor,       # (B, V) bf16 on the card; masked columns -1e30
    temperature: torch.Tensor,  # (B,) <= 0: greedy
    top_k: torch.Tensor,        # (B,) 0 disables
    top_p: torch.Tensor,        # (B,) 1.0 disables
    seed: torch.Tensor,         # (B,) integer, taken mod 2^32
    step: torch.Tensor,         # (B,) integer generation index
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tok (B,) int32, logp (B,) fp32)."""
    if logits.device.type == "cpu":
        return sample_ref(logits, temperature, top_k, top_p, seed, step)
    vecs = (temperature, top_k, top_p, seed, step)
    _build.check_device("fused_sample", logits, *vecs)
    if logits.dim() != 2 or logits.stride(1) != 1 or logits.dtype != torch.bfloat16:
        raise ValueError(f"fused_sample takes (B, V) bf16 logits with a contiguous "
                         f"vocab dim; got {tuple(logits.shape)} {logits.dtype} "
                         f"strides {logits.stride()}")
    B, V = logits.shape
    if any(t.shape != (B,) for t in vecs):
        raise ValueError(f"per-row params must have shape ({B},); got "
                         f"{[tuple(t.shape) for t in vecs]}")
    temp = temperature.to(torch.float32).contiguous()
    k = top_k.to(torch.int32).contiguous()
    p = top_p.to(torch.float32).contiguous()
    s, st = _u32_bits(seed), _u32_bits(step)
    tok = torch.empty((B,), dtype=torch.int32, device=logits.device)
    logp = torch.empty((B,), dtype=torch.float32, device=logits.device)
    if B == 0:
        return tok, logp
    err = _fn()(
        logits.data_ptr(), B, V, logits.stride(0),
        temp.data_ptr(), k.data_ptr(), p.data_ptr(), s.data_ptr(), st.data_ptr(),
        tok.data_ptr(), logp.data_ptr(), torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_sample kernel launch failed: cudaError {err}")
    fused_sample.launches += 1
    return tok, logp


fused_sample.launches = 0
