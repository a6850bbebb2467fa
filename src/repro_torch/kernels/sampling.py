"""Fused sampling: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``fused_sample`` (``_sample_kernel``) of the
reference package: per-row temperature, top-k and top-p by dual
bisection, and Gumbel-max with the counter-hash (murmur3 fmix32) noise,
greedy rows returning the first-index argmax.  The kernel is
``csrc/sampling.cu`` (CUDA C++ for sm_90a: a row spread over a cluster of
four blocks that hold its slices in shared memory, the bisection walked
several levels a pass; its source note gives the design and the bound).
The plain version is ``ref.sample_ref``; both compute the reference's ``_sample_rows`` row
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

_fn_c = None


def _fn():
    """The kernel's C entry point, its argument types set once."""
    global _fn_c
    if _fn_c is None:
        fn = _build.load("sampling").fused_sample
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, ctypes.c_int64] + [p] * 7 + [p]
        fn.restype = i
        _fn_c = fn
    return _fn_c


def _u32_bits(t: torch.Tensor) -> torch.Tensor:
    """An integer tensor as the int32 bit pattern of its value mod 2^32."""
    if t.dtype == torch.int32:
        return t.contiguous()
    u = t.long() & 0xFFFFFFFF
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def check_args(logits: torch.Tensor, *vecs: torch.Tensor) -> None:
    """Raise on what the kernel does not take (any device): (B, V) bf16
    logits with a contiguous vocab dim, V >= 1, and five (B,) per-row
    vectors on the logits' device."""
    if logits.dim() != 2 or logits.stride(1) != 1 or logits.dtype != torch.bfloat16:
        raise ValueError(f"fused_sample takes (B, V) bf16 logits with a contiguous "
                         f"vocab dim; got {tuple(logits.shape)} {logits.dtype} "
                         f"strides {logits.stride()}")
    B, V = logits.shape
    if V < 1 and B:
        raise ValueError("fused_sample: the vocabulary is empty")
    if any(t.shape != (B,) for t in vecs):
        raise ValueError(f"per-row params must have shape ({B},); got "
                         f"{[tuple(t.shape) for t in vecs]}")
    if any(t.device != logits.device for t in vecs):
        raise ValueError(f"fused_sample: operands must share one device; got "
                         f"{[str(t.device) for t in (logits, *vecs)]}")


def fused_sample(
    logits: torch.Tensor,       # (B, V) bf16 on the card; masked columns -1e30
    temperature: torch.Tensor,  # (B,) <= 0: greedy
    top_k: torch.Tensor,        # (B,) 0 disables
    top_p: torch.Tensor,        # (B,) 1.0 disables
    seed: torch.Tensor,         # (B,) integer, taken mod 2^32
    step: torch.Tensor,         # (B,) integer generation index
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tok (B,) int32, logp (B,) fp32).  On the card the common case (the
    engine's fp32 temperature and top-p, int32 top-k, seed and step) costs
    attribute reads, two allocations and the launch; other dtypes are
    converted, and the full checks run only to name what the kernel does
    not take."""
    if not logits.is_cuda:
        if logits.device.type == "cpu":
            return sample_ref(logits, temperature, top_k, top_p, seed, step)
        raise ValueError(f"fused_sample: logits must lie on the CPU or a CUDA device; got "
                         f"{logits.device}")
    fn = _fn_c or _fn()
    dev = logits.get_device()
    if logits.dim() != 2 or logits.dtype != torch.bfloat16 or logits.stride(1) != 1:
        check_args(logits, temperature, top_k, top_p, seed, step)
    B, V = logits.shape
    want = (B,)
    if (temperature.shape != want or top_k.shape != want or top_p.shape != want
            or seed.shape != want or step.shape != want or (V < 1 and B)
            or temperature.get_device() != dev or top_k.get_device() != dev
            or top_p.get_device() != dev or seed.get_device() != dev or step.get_device() != dev):
        _build.check_device("fused_sample", logits, temperature, top_k, top_p, seed, step)
        check_args(logits, temperature, top_k, top_p, seed, step)
    f32, i32 = torch.float32, torch.int32
    temp = temperature if temperature.dtype == f32 and temperature.is_contiguous() else \
        temperature.to(f32).contiguous()
    k = top_k if top_k.dtype == i32 and top_k.is_contiguous() else top_k.to(i32).contiguous()
    p = top_p if top_p.dtype == f32 and top_p.is_contiguous() else top_p.to(f32).contiguous()
    s = seed if seed.dtype == i32 and seed.is_contiguous() else _u32_bits(seed)
    st = step if step.dtype == i32 and step.is_contiguous() else _u32_bits(step)
    tok = logits.new_empty((B,), dtype=torch.int32)
    logp = logits.new_empty((B,), dtype=torch.float32)
    if B == 0:
        return tok, logp
    err = fn(logits.data_ptr(), B, V, logits.stride(0), temp.data_ptr(), k.data_ptr(),
             p.data_ptr(), s.data_ptr(), st.data_ptr(), tok.data_ptr(), logp.data_ptr(),
             torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"fused_sample kernel launch failed: cudaError {err}")
    fused_sample.launches += 1
    return tok, logp


fused_sample.launches = 0
