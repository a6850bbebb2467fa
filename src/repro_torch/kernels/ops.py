"""Dispatch of the port's hot-path ops.

``impl="auto"`` (the default, and ``ModelConfig.kernel_impl``'s) hands the
tensors to the kernel wrappers: a CUDA tensor launches the hand-written
kernels — a failed launch raises, nothing falls back — and a CPU tensor
runs the plain PyTorch versions.  ``impl="torch"`` runs the plain versions
on any device; only the tests and ``chip_smoke.py`` use it, to hold the
kernels against it.  Every op here is differentiable on both
implementations: attention and cross-entropy pair their forward and
backward kernels (or plain versions) in a ``torch.autograd.Function``, as
the reference's custom VJPs do, and so does the MoE's ragged grouped
matmul (its forward kernel, the same kernel on the transposed weights for
dx, and the weight-gradient kernel), and the Mamba-2 SSD scan (its
forward kernel, which then keeps each chunk's entering state, and the
port's own backward kernel), and LayerNorm (its forward kernel and the
port's own backward kernel); RMSNorm pairs its forward kernel with the
reference's hand-written backward formulas.  Both norms call their forward
directly when no gradient is wanted.  The serving-only ops — decode
attention, the paged-KV ops and sampling — are forward-only.  The paged-KV
writes and the SSD decode step update the cache in place (the reference
donates its buffers and returns new ones).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import cross_entropy as _ce
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _ln
from repro_torch.kernels import sampling as _sp
from repro_torch.kernels import ssd_scan as _ss

IMPLS = ("auto", "torch")


def _plain(impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of {IMPLS}")
    return impl == "torch"


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


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
    return _fa.attention(q, k, v, causal=causal, window=window, softcap=softcap,
                         q_offset=q_offset, plain=_plain(impl))


def layernorm(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """LayerNorm over the last dim, fp32 math, output in x.dtype;
    differentiable.  Without a gradient to take (serving, or
    ``torch.no_grad``) the forward is called directly: no autograd node,
    the same output."""
    plain = _plain(impl)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or (b is not None and b.requires_grad)):
        return _ln.layernorm_ad(x, w, b, eps, plain=plain)
    return (_ref.layernorm_ref if plain else _ln.layernorm)(x, w, b, eps)


def cross_entropy(
    hidden: torch.Tensor,
    w: torch.Tensor,
    targets: torch.Tensor,
    *,
    vocab: int = 0,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden (T, D) · w (D, Vpad) -> per-token (loss, lse), both (T,) fp32;
    columns >= vocab are masked.  The (T, Vpad) logits never materialize on
    the kernel path."""
    return _ce.cross_entropy(hidden, w, targets, vocab=vocab, plain=_plain(impl))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *,
            impl: str = "auto") -> torch.Tensor:
    """RMSNorm over the last dim, fp32 math, output in x.dtype;
    differentiable.  Without a gradient to take (serving, or
    ``torch.no_grad``) the forward is called directly: no autograd node,
    the same output."""
    plain = _plain(impl)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ln.rmsnorm_ad(x, w, eps, plain=plain)
    return (_ref.rmsnorm_ref if plain else _ln.rmsnorm)(x, w, eps)


def decode_attention(
    q: torch.Tensor,          # (B, 1, H, D)
    k_cache: torch.Tensor,    # (B, T, Hkv, D)
    v_cache: torch.Tensor,
    length: torch.Tensor,     # (B,) valid cache length per row
    *,
    softcap: float = 0.0,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-token attention over a dense KV cache -> (B, 1, H, D); a row
    of length 0 (an idle serving slot) gives zeros."""
    if _plain(impl):
        return _ref.decode_attention_ref(q, k_cache, v_cache, length, softcap=softcap)
    return _fd.flash_decode(q, k_cache, v_cache, length.to(torch.int32).contiguous(),
                            softcap=softcap)


def paged_decode_attention(
    q: torch.Tensor,            # (B, 1, H, D)
    k_pool: torch.Tensor,       # (num_pages, page, Hkv, D)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, pages_per_seq) int32
    length: torch.Tensor,       # (B,) valid cache length per sequence
    *,
    softcap: float = 0.0,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-token attention through a block-table paged KV pool ->
    (B, 1, H, D); the kernel reads K/V through the table (no dense cache is
    built), the plain version gathers the pages first."""
    if _plain(impl):
        return _ref.paged_decode_attention_ref(q, k_pool, v_pool, block_table, length,
                                               softcap=softcap)
    return _pa.paged_decode(q, k_pool, v_pool, _i32(block_table), _i32(length), softcap=softcap)


def paged_decode_append(
    q: torch.Tensor,            # (B, 1, H, D)
    k_pool: torch.Tensor,       # (num_pages, page, Hkv, D)
    v_pool: torch.Tensor,
    k_new: torch.Tensor,        # (B, 1, Hkv, D) decode-token K per slot
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # (B, pages_per_seq) int32
    length: torch.Tensor,       # (B,) valid cache length per sequence, >= 1
    page_idx: torch.Tensor,     # (B,) physical page holding position length - 1
    row: torch.Tensor,          # (B,) row within the page
    *,
    softcap: float = 0.0,
    impl: str = "auto",
) -> torch.Tensor:
    """The paged decode step's K/V insert and attention -> (B, 1, H, D):
    slot b's new K/V row goes in place to ``(page_idx[b], row[b])``, which
    must be where the table maps position ``length[b] - 1``
    (``models.attention.paged_decode_addressing``), then each query attends
    over its first ``length[b]`` positions.  On a CUDA tensor one launch of
    the paged decode kernel does both; the plain version is
    ``paged_kv_update`` then ``paged_decode_attention``."""
    k_new, v_new = k_new.to(k_pool.dtype), v_new.to(v_pool.dtype)
    if _plain(impl):
        return _ref.paged_decode_append_ref(q, k_pool, v_pool, block_table, length, k_new, v_new,
                                            _i32(page_idx), _i32(row), softcap=softcap)
    return _pa.paged_decode(q, k_pool, v_pool, _i32(block_table), _i32(length), softcap=softcap,
                            k_new=k_new, v_new=v_new, page_idx=_i32(page_idx), row=_i32(row))


def paged_prefill_attention(
    q: torch.Tensor,            # (B, S, H, D) chunk queries
    k_pool: torch.Tensor,       # (num_pages, page, Hkv, D)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, pages_per_seq) int32
    starts: torch.Tensor,       # (B,) position of each chunk's row 0
    lengths: torch.Tensor,      # (B,) valid context length (start + valid rows)
    *,
    softcap: float = 0.0,
    impl: str = "auto",
) -> torch.Tensor:
    """Chunk attention through a block-table paged KV pool -> (B, S, H, D):
    query row i sits at ``starts[b] + i`` and attends to every position
    ``<= starts[b] + i`` and ``< lengths[b]`` — pages shared from the
    prefix cache and earlier chunks included.  The chunk's own K/V must
    already be in the pool (``paged_kv_update_rows``)."""
    if _plain(impl):
        return _ref.paged_prefill_attention_ref(q, k_pool, v_pool, block_table, starts, lengths,
                                                softcap=softcap)
    return _pa.paged_prefill(q, k_pool, v_pool, _i32(block_table), _i32(starts), _i32(lengths),
                             softcap=softcap)


def paged_kv_update_rows(
    k_pool: torch.Tensor,       # (num_pages, page, Hkv, D)
    v_pool: torch.Tensor,
    k_new: torch.Tensor,        # (S, Hkv, D) a batch-1 chunk's K rows
    v_new: torch.Tensor,
    page_idx: torch.Tensor,     # (S,) physical page per row (null page = masked)
    row: torch.Tensor,          # (S,) row within each page
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a prefill chunk's K/V rows into the pools, in place; returns
    the pools.  O(S) rows move whatever the implementation, so this is an
    indexed write on both (the reference's is a jnp scatter, not a
    kernel).  Masked rows target the null page 0, where collisions are
    harmless."""
    idx = (page_idx.long(), row.long())
    k_pool.index_put_(idx, k_new.to(k_pool.dtype))
    v_pool.index_put_(idx, v_new.to(v_pool.dtype))
    return k_pool, v_pool


def paged_kv_update(
    k_pool: torch.Tensor,       # (num_pages, page, Hkv, D)
    v_pool: torch.Tensor,
    k_new: torch.Tensor,        # (B, 1, Hkv, D) decode-token K per slot
    v_new: torch.Tensor,
    page_idx: torch.Tensor,     # (B,) physical page holding each slot's write pos
    row: torch.Tensor,          # (B,) row within the page (pos % page)
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one decode token per slot at (page_idx, row), in place;
    returns the pools.  One kernel launch writes K and V.  The model's
    decode step inserts through ``paged_decode_append`` instead, inside
    the decode kernel."""
    k_new, v_new = k_new.to(k_pool.dtype), v_new.to(v_pool.dtype)
    fn = _ref.paged_kv_write_ref if _plain(impl) else _pa.paged_kv_write
    fn(k_pool, v_pool, k_new, v_new, _i32(page_idx), _i32(row))
    return k_pool, v_pool


def sample_tokens(
    logits: torch.Tensor,       # (B, V) last-position logits
    temperature: torch.Tensor,  # (B,) <= 0 means greedy argmax
    top_k: torch.Tensor,        # (B,) 0 disables the top-k filter
    top_p: torch.Tensor,        # (B,) 1.0 disables the top-p filter
    seed: torch.Tensor,         # (B,) per-request seed, taken mod 2^32
    step: torch.Tensor,         # (B,) generation index (tokens emitted so far)
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token per row with per-row params -> (tok (B,) int32, logp (B,)
    fp32), selected on the device: logp is the chosen token's
    log-probability under the filtered, temperature-scaled, renormalized
    distribution (greedy rows: under the full T=1 softmax)."""
    fn = _ref.sample_ref if _plain(impl) else _sp.fused_sample
    return fn(logits, temperature, top_k, top_p, seed, step)


def grouped_matmul(
    x: torch.Tensor,            # (M, K) rows sorted by group
    w: torch.Tensor,            # (E, K, N) per-group (expert) weights
    group_sizes: torch.Tensor,  # (E,) int32 contiguous row counts, on x's device
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Ragged grouped matmul ``y[i] = x[i] @ w[g(i)]`` -> (M, N) in x.dtype
    with fp32 accumulation: the MoE expert FFN after sort-by-expert
    dispatch.  Rows past ``sum(group_sizes)`` (capacity-dropped slots) come
    back exactly 0 and empty groups cost no work.  The sizes stay on the
    device on both implementations.  Differentiable: on a CUDA tensor
    ``auto`` pairs the kernels (``gmm``, ``gmm`` on the transposed weights
    for dx, ``gmm_dw`` for dW); ``torch`` and the CPU run the plain
    version under autograd."""
    if _plain(impl) or x.device.type == "cpu":
        return _ref.grouped_matmul_ref(x, w, group_sizes)
    return _gm.grouped_matmul(x, w, _i32(group_sizes))


def ssd(
    x: torch.Tensor,            # (B, S, H, P)
    dt: torch.Tensor,           # (B, S, H) fp32, positive
    A: torch.Tensor,            # (H,) negative
    Bm: torch.Tensor,           # (B, S, G, N)
    Cm: torch.Tensor,           # (B, S, G, N)
    D: torch.Tensor,            # (H,)
    *,
    chunk: int = 64,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 SSD scan over a whole sequence from a zero state ->
    (y (B, S, H, P) in x.dtype, final state (B, H, P, N) fp32), in the
    chunked dual form with fp32 products; any S.  ``chunk`` sets the plain
    version's chunk only: the kernels ignore it and always chunk at 64
    rows (the function does not depend on it beyond fp32 rounding).
    Differentiable on every device: ``auto`` goes through
    ``ssd_scan.SSDScan``, whose forward keeps the state entering each chunk
    and whose backward is the SSD backward kernel on a CUDA tensor (the
    port's own; the reference differentiates its jnp scan) and the explicit
    chunked backward ``ssd_scan_bwd_ref`` on a CPU one; ``torch`` runs the
    plain forward under autograd."""
    if _plain(impl):
        return _ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk)
    return _ss.ssd_scan(x, dt, A, Bm, Cm, D, chunk)


def ssd_decode_step(
    x: torch.Tensor,            # (B, 1, H, P)
    dt: torch.Tensor,           # (B, 1, H)
    A: torch.Tensor,            # (H,)
    Bm: torch.Tensor,           # (B, 1, G, N)
    Cm: torch.Tensor,           # (B, 1, G, N)
    D: torch.Tensor,            # (H,)
    state: torch.Tensor,        # (B, H, P, N) fp32, advanced in place
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step (serving) -> (y (B, 1, H, P) in x.dtype,
    state).  Plain PyTorch on every implementation and device: the
    reference computes it outside any TPU kernel."""
    _plain(impl)
    return _ref.ssd_decode_step_ref(x, dt, A, Bm, Cm, D, state)
