"""Ragged grouped matmul: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``gmm`` (``_gmm_kernel``) of the reference package:
``y[i] = x[i] @ w[g(i)]`` for rows sorted by group, with the per-group row
counts ``group_sizes`` on the device, fp32 accumulation, the output in
x.dtype, and rows at or past ``sum(group_sizes)`` exactly 0 — the expert
GEMMs of the MoE layer after sort-by-expert dispatch.  The kernel is
``csrc/grouped_matmul.cu`` (CUDA C++ for sm_90a: every block derives the
(group, m-tile) schedule from the sizes on the device, the grid is fixed by
static bounds, and each block stores only its group's rows; its source note
gives the design and the bound).  The plain version is
``ref.grouped_matmul_ref``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  Nothing reads ``group_sizes`` on the host, so a call makes no
host sync.  Forward only: the kernel raises when asked for a gradient (its
backward, the reference's ``gmm_dw``, comes with the MoE training path).
``gmm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul_ref

_MAX_GROUPS = 128   # the kernel's schedule scans one group per thread of a block


def block_m(M: int) -> int:
    """Rows per m-tile: 16 at decode sizes (a few rows per expert), 64 above."""
    return 16 if M <= 128 else 64


def check_args(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> None:
    """Raise on what the kernel does not take (any device)."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"expected x (M, K) and w (E, K, N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    E, K, N = w.shape
    if group_sizes.shape != (E,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32 ({E},); got {tuple(group_sizes.shape)} "
                         f"{group_sizes.dtype}")
    if not 0 < E <= _MAX_GROUPS:
        raise ValueError(f"gmm takes 1 to {_MAX_GROUPS} groups, got {E}")
    if x.dtype != torch.bfloat16 or w.dtype != x.dtype:
        raise TypeError(f"gmm takes bfloat16 operands on the card; got {x.dtype}, {w.dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"gmm needs K and N multiples of 8 (16-byte rows); got K={K}, N={N}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not group_sizes.is_contiguous():
        raise ValueError("group_sizes must be contiguous")


def _lib():
    lib = _build.load("grouped_matmul")
    if lib.grouped_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_matmul.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.grouped_matmul.restype = i
    return lib


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """(M, N) in x.dtype: row i of x times the weight of its group; rows at
    or past ``sum(group_sizes)`` are 0."""
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, group_sizes)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "gmm: the kernel is forward-only; its backward (gmm_dw) comes with the MoE "
            "training path (ROADMAP: port queue)")
    _build.check_device("gmm", x, w, group_sizes)
    check_args(x, w, group_sizes)
    M = x.shape[0]
    E, K, N = w.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    err = _lib().grouped_matmul(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
                                M, K, N, E, block_m(M),
                                torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gmm kernel launch failed: cudaError {err}")
    gmm.launches += 1
    return y


gmm.launches = 0
