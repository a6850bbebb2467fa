"""Ragged grouped matmul and its backward: the CUDA kernels' wrappers, their
plain versions, the host side of the kernels' schedules, and the
differentiable op that pairs them.

``gmm`` replaces the TPU kernel ``gmm`` (``_gmm_kernel``) of the reference
package: ``y[i] = x[i] @ w[g(i)]`` for rows sorted by group, with the
per-group row counts ``group_sizes`` on the device, fp32 accumulation, the
output in x.dtype, and rows at or past ``sum(group_sizes)`` exactly 0 — the
expert GEMMs of the MoE layer after sort-by-expert dispatch.  With
``transpose_w`` it computes ``x[i] @ w[g(i)]ᵀ`` from the same (E, K, N)
weights, the backward's dx, with no transposed copy.  ``gmm_dw`` replaces
``gmm_dw`` (``_tgmm_kernel``): ``dw[g] = x_gᵀ · dy_g`` -> (E, K, N), fp32
sums, an empty group's slice exactly 0.  The kernels are in
``csrc/grouped_matmul.cu``, CUDA C++ for sm_90a: persistent wgmma + TMA
kernels on ``csrc/hopper.cuh`` (a producer warpgroup, two consumer
warpgroups).  The forward has two modes: above ``SPLIT_MAX_ROWS`` rows the
transposed mode's row tiles of 256 from each group's start; at or below
(decode) the weights on wgmma's M side, each live group's K split S ways
into an fp32 workspace that a second kernel adds up in order.  dW is
written through TMA stores.  Every block derives its work from the sizes
on the device, the grids are fixed by static bounds, and each output
element is summed in one fixed order, so a call repeats bit for bit; the
source note gives the designs and the bounds.  The plain versions are
``ref.grouped_matmul_ref`` and ``ref.grouped_matmul_dw_ref``.

The kernels' schedules are mirrored here so that the CPU tests reach them:
``group_starts`` (each group's first row), ``fwd_split`` and ``fwd_items``
(the forward's items in either mode), ``dw_tiles`` (the gmm_dw tiles:
group, 128 rows of K, 256 columns of N), ``dw_slices`` (a group's 64-row
slices) and ``dx_items`` (the transposed mode's row tiles of 256 from each
group's start, then the zero tail); the kernels compute the same on the
device.

``grouped_matmul`` is the ``torch.autograd.Function`` that pairs them as
the reference's ``_gmm_pallas_fwd/_bwd`` do: dx by ``gmm`` on the
transposed weights, rounded to x.dtype, and dW by ``gmm_dw``, its fp32 sums
rounded once to w.dtype (the kernel writes it in that dtype directly);
the sizes get no cotangent.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  Nothing reads ``group_sizes`` on the host, so a call makes no
host sync.  ``gmm.launches`` (one a call of the forward, whose decode
mode launches its sum pass beside it, or of the transposed mode),
``gmm.dx_launches`` (the transposed mode alone) and ``gmm_dw.launches``
count kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul_dw_ref, grouped_matmul_ref

_MAX_GROUPS = 128   # the schedules scan the groups' sizes with one warp, 5 a lane

# the kernels' tiles (csrc/grouped_matmul.cu, namespaces persistent::dw, ::dx
# and ::split; the forward's row-tile mode takes dx's)
SLICE = 64             # rows of x and dy a gmm_dw slice; depth of a dx or forward slice
DW_TILE_K = 128        # rows of dW (K) a tile
DW_TILE_N = 256        # columns of dW (N) a tile
DX_TILE_M = 256        # rows a transposed-mode tile: four m64 blocks from the group's start
DX_TILE_N = 128        # output columns a transposed-mode tile
SPLIT_MAX_ROWS = 128   # M at or below: the forward's decode mode
SPLIT_CHUNK = 32       # rows a decode-mode product takes at once (wgmma n 8, 16 or 32)
SPLIT_TILE_N = 128     # output columns a decode-mode item
MAX_SPLIT = 8          # K splits at most: the workspace's partials
SPLIT_ITEM_COST = 1    # an item's fixed cost, in slices, when the split is chosen
SMS = 132              # an H100 SXM's SM count: the kernels' grid, the mirror's default


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def group_starts(sizes: Sequence[int], M: int) -> List[int]:
    """The first row of each group and, last, ``min(sum(sizes), M)``: the
    exclusive prefix sums of the sizes (negative ones as 0), each capped at
    M, as the kernels' schedules compute them."""
    out, run = [], 0
    for s in sizes:
        out.append(min(run, M))
        run += max(int(s), 0)
    return out + [min(run, M)]


def dw_tiles(E: int, K: int, N: int) -> List[Tuple[int, int, int]]:
    """The gmm_dw kernel's tiles in order (block b takes tiles b, b + grid,
    ...): (group, first row of K, first column of N); group-major, then N
    tile, then K tile.  Every group's tiles are there, an empty group's
    too: the kernel stores its zeros."""
    return [(g, tk * DW_TILE_K, tn * DW_TILE_N) for g in range(E)
            for tn in range(_cdiv(N, DW_TILE_N)) for tk in range(_cdiv(K, DW_TILE_K))]


def dw_slices(starts: Sequence[int], g: int) -> List[Tuple[int, int]]:
    """Group g's 64-row slices, each tile of the group sums over, as (first
    row, rows of the group in it), from the group's first row; the kernel
    zeroes a slice's rows past the group."""
    start, end = starts[g], starts[g + 1]
    return [(m0, min(SLICE, end - m0)) for m0 in range(start, end, SLICE)]


def dx_items(sizes: Sequence[int], M: int, N: int) -> List[Tuple[int, int, int, int]]:
    """The transposed mode's work items in order: (group, first row, end
    row, first output column).  Each group's rows split into tiles of
    ``DX_TILE_M`` from the group's start, so no tile spans two groups, and
    a group's row tiles of one column tile run side by side (column tile
    major); then rows ``[sum(sizes), M)`` as a last pseudo-group E,
    written as zeros."""
    starts = group_starts(sizes, M)
    E = len(sizes)
    items = []
    for q in range(E + 1):
        lo, end = starts[q], starts[q + 1] if q < E else M
        rows = list(range(lo, end, DX_TILE_M))
        items += [(q, m0, min(end, m0 + DX_TILE_M), tn * DX_TILE_N)
                  for tn in range(_cdiv(N, DX_TILE_N)) for m0 in rows]
    return items


def dx_grid_bound(M: int, E: int, N: int) -> int:
    """The transposed mode's static bound on its items (its grid is the
    smaller of this and the SM count): every group adds at most one partial
    row tile, the tail one more."""
    return (_cdiv(M, DX_TILE_M) + E + 1) * _cdiv(N, DX_TILE_N)


def fwd_split(tiles: int, n_slices: int, sms: int = SMS) -> int:
    """The decode mode's number of K splits (``pick_split``): the S in 1 ..
    ``MAX_SPLIT`` (at most ``n_slices``) whose ``tiles`` x S items take the
    fewest slices on the busiest of ``sms`` blocks, counting each item's
    fixed cost; the smaller S on a tie."""
    best, best_cost = 1, None
    for s in range(1, min(MAX_SPLIT, n_slices) + 1):
        cost = _cdiv(tiles * s, sms) * (_cdiv(n_slices, s) + SPLIT_ITEM_COST)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def fwd_items(sizes: Sequence[int], M: int, K: int, N: int, sms: int = SMS
              ) -> List[Tuple[int, int, int, int, int, int]]:
    """The forward's work items in order: (group, first row, end row, first
    output column, first and end depth).  Above ``SPLIT_MAX_ROWS`` rows the
    row-tile mode's, ``dx_items`` over the whole depth, the zero tail as
    pseudo-group E.  At or below, the decode mode's: for each live group,
    column tile and K split, split fastest, all the group's rows over
    1 / S of the 64-deep slices; then, as pseudo-group E with no depth, the
    rows past the groups that the sum pass writes as zeros."""
    if M > SPLIT_MAX_ROWS:
        return [(q, m0, hi, n0, 0, K) for q, m0, hi, n0 in dx_items(sizes, M, N)]
    starts = group_starts(sizes, M)
    E = len(sizes)
    live = [g for g in range(E) if starts[g + 1] > starts[g]]
    tiles_n, n_slices = _cdiv(N, SPLIT_TILE_N), _cdiv(K, SLICE)
    S = fwd_split(len(live) * tiles_n, n_slices, sms)
    items = [(g, starts[g], starts[g + 1], t * SPLIT_TILE_N, SLICE * (k * n_slices // S),
              min(K, SLICE * ((k + 1) * n_slices // S)))
             for g in live for t in range(tiles_n) for k in range(S)]
    if starts[E] < M:
        items += [(E, starts[E], M, t * SPLIT_TILE_N, 0, 0) for t in range(tiles_n)]
    return items


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
        lib.grouped_matmul.argtypes = [p] * 5 + [i] * 5 + [p]
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
    ws = None   # the decode mode's partial sums, one (M, N) fp32 slice a K split
    if not transpose_w and M <= SPLIT_MAX_ROWS:
        ws = torch.empty((MAX_SPLIT, M, N), dtype=torch.float32, device=x.device)
    err = _lib().grouped_matmul(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
                                None if ws is None else ws.data_ptr(), M, K, N, E,
                                int(transpose_w), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gmm kernel launch failed: cudaError {err}")
    gmm.launches += 1
    gmm.dx_launches += int(transpose_w)
    return y


gmm.launches = 0
gmm.dx_launches = 0   # of gmm.launches, those of the transposed mode (gmm_dx_kernel)


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
