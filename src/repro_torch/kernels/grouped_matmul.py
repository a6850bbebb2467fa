"""Ragged grouped matmul and its backward: the CUDA kernels' wrappers, their
plain versions, and the differentiable op that pairs them.

``gmm`` replaces the TPU kernel ``gmm`` (``_gmm_kernel``) of the reference
package: ``y[i] = x[i] @ w[g(i)]`` for rows sorted by group, with the
per-group row counts ``group_sizes`` on the device, fp32 accumulation, the
output in x.dtype, and rows at or past ``sum(group_sizes)`` exactly 0 — the
expert GEMMs of the MoE layer after sort-by-expert dispatch.  With
``transpose_w`` it computes ``x[i] @ w[g(i)]ᵀ`` from the same (E, K, N)
weights, the backward's dx, with no transposed copy.  ``gmm_dw`` replaces
``gmm_dw`` (``_tgmm_kernel``): ``dw[g] = x_gᵀ · dy_g`` -> (E, K, N), fp32
sums, an empty group's slice exactly 0.  The kernels are in
``csrc/grouped_matmul.cu`` (CUDA C++ for sm_90a: every block derives its
group's rows from the sizes on the device, the grids are fixed by static
bounds, and no two blocks write one element; its source note gives the
designs and the bounds).  The plain versions are ``ref.grouped_matmul_ref``
and ``ref.grouped_matmul_dw_ref``.

``grouped_matmul`` is the ``torch.autograd.Function`` that pairs them as
the reference's ``_gmm_pallas_fwd/_bwd`` do: dx by ``gmm`` on the
transposed weights, rounded to x.dtype, and dW by ``gmm_dw``, its fp32 sums
rounded once to w.dtype (the kernel writes it in that dtype directly);
the sizes get no cotangent.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  Nothing reads ``group_sizes`` on the host, so a call makes no
host sync.  ``gmm.launches`` (the forward and the transposed mode) and
``gmm_dw.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul_dw_ref, grouped_matmul_ref

_MAX_GROUPS = 128   # the kernels' schedule scans one group per thread of a block


def block_m(M: int) -> int:
    """Rows per m-tile: 16 at decode sizes (a few rows per expert), 64 above."""
    return 16 if M <= 128 else 64


def _check_sizes(name: str, E: int, group_sizes: torch.Tensor) -> None:
    if group_sizes.shape != (E,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32 ({E},); got {tuple(group_sizes.shape)} "
                         f"{group_sizes.dtype}")
    if not 0 < E <= _MAX_GROUPS:
        raise ValueError(f"{name} takes 1 to {_MAX_GROUPS} groups, got {E}")
    if not group_sizes.is_contiguous():
        raise ValueError("group_sizes must be contiguous")


def _check_operands(name: str, K: int, N: int, **tensors: torch.Tensor) -> None:
    if any(t.dtype != torch.bfloat16 for t in tensors.values()):
        raise TypeError(f"{name} takes bfloat16 operands on the card; got "
                        f"{[t.dtype for t in tensors.values()]}")
    if K % 8 or N % 8:
        raise ValueError(f"{name} needs K and N multiples of 8 (16-byte rows); got K={K}, N={N}")
    for key, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{key} must be contiguous and 16-byte aligned")


def check_args(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
               transpose_w: bool = False) -> None:
    """Raise on what the gmm kernel does not take (any device)."""
    depth = 2 if transpose_w else 1
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[depth]:
        want = "(E, N, K)" if transpose_w else "(E, K, N)"
        raise ValueError(f"expected x (M, K) and w {want}; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    _check_sizes("gmm", w.shape[0], group_sizes)
    _check_operands("gmm", w.shape[1], w.shape[2], x=x, w=w)


def check_dw_args(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> None:
    """Raise on what the gmm_dw kernel does not take (any device)."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"expected x (M, K) and dy (M, N); got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    _check_sizes("gmm_dw", group_sizes.shape[0] if group_sizes.dim() == 1 else 0, group_sizes)
    _check_operands("gmm_dw", x.shape[1], dy.shape[1], x=x, dy=dy)


def _lib():
    lib = _build.load("grouped_matmul")
    if lib.grouped_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_matmul.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.grouped_matmul.restype = i
        lib.grouped_matmul_dw.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.grouped_matmul_dw.restype = i
    return lib


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
        transpose_w: bool = False) -> torch.Tensor:
    """(M, N) in x.dtype: row i of x times the weight of its group (its
    transpose with ``transpose_w``: w is then read as (E, N, K)); rows at
    or past ``sum(group_sizes)`` are 0."""
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w.transpose(1, 2) if transpose_w else w, group_sizes)
    _build.check_device("gmm", x, w, group_sizes)
    check_args(x, w, group_sizes, transpose_w)
    M = x.shape[0]
    E, K, N = w.shape
    if transpose_w:
        K, N = N, K
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    err = _lib().grouped_matmul(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
                                M, K, N, E, block_m(M), int(transpose_w),
                                torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gmm kernel launch failed: cudaError {err}")
    gmm.launches += 1
    return y


gmm.launches = 0


def gmm_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor, *,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(E, K, N): ``x_gᵀ · dy_g`` over each group's rows, fp32 sums written
    in ``out_dtype`` (fp32 or bf16; the plain version rounds its fp32
    result); an empty group's slice is 0."""
    if x.device.type == "cpu":
        return grouped_matmul_dw_ref(x, dy, group_sizes).to(out_dtype)
    _build.check_device("gmm_dw", x, dy, group_sizes)
    check_dw_args(x, dy, group_sizes)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gmm_dw writes float32 or bfloat16, not {out_dtype}")
    (M, K), N, E = x.shape, dy.shape[1], group_sizes.shape[0]
    dw = torch.empty((E, K, N), dtype=out_dtype, device=x.device)
    err = _lib().grouped_matmul_dw(x.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(),
                                   dw.data_ptr(), M, K, N, E, int(out_dtype == torch.bfloat16),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gmm_dw kernel launch failed: cudaError {err}")
    gmm_dw.launches += 1
    return dw


gmm_dw.launches = 0


class _GroupedMatmul(torch.autograd.Function):
    """Forward: ``gmm``; backward: dx = ``gmm(dy, w, transpose_w=True)`` in
    x.dtype and dW = ``gmm_dw(x, dy)`` in w.dtype, no cotangent for the
    sizes — the reference's ``_gmm_pallas_fwd/_bwd``."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return gmm(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, gs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = gmm(dy, w, gs, transpose_w=True).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = gmm_dw(x, dy, gs, out_dtype=w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor
                   ) -> torch.Tensor:
    """Differentiable ragged grouped matmul on the kernels (``gmm`` and
    ``gmm_dw`` on a CUDA tensor, their plain versions on the CPU)."""
    return _GroupedMatmul.apply(x, w, group_sizes)
