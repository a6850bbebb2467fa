"""Plain PyTorch versions of the port's kernels.

Each function here is the semantic definition its kernel is held to: the
CPU path runs it, the CPU tests hold it against the reference package, and
``chip_smoke.py`` holds each kernel against it on the card.  Written for
clarity — attention materializes the full (B, H, S, T) fp32 score tensor,
cross-entropy the full (T, Vpad) fp32 logits, sampling sweeps the whole
(B, V) row once per bisection step.  The backward versions are
explicit formulas, not autograd of the forward: they keep the reference
kernels' fp32 math and edge cases (clamped exponents, masked rows and
vocab columns).
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
    s = torch.where(_mask(S, T, causal, window, q_offset, q.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhst,bthd->bshd", p, vf) / l.transpose(1, 2)
    lse = (m + torch.log(l)).reshape(B * H, S)
    return out.to(q.dtype), lse


def attention_bwd_ref(
    q: torch.Tensor,          # (B, S, H, D)
    k: torch.Tensor,          # (B, T, Hkv, D)
    v: torch.Tensor,          # (B, T, Hkv, D)
    out: torch.Tensor,        # (B, S, H, D) forward output
    lse: torch.Tensor,        # (B·H, S) fp32 forward residual
    do: torch.Tensor,         # (B, S, H, D) output cotangent
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward: (dq, dk, dv) in the input dtypes.

    The reference's ``_recompute_p_ds`` over the whole (S, T) plane in fp32:
    p = exp(min(z − lse, 0)) gated by the mask (a fully-masked row, lse =
    −1e30, gives zero gradient), Δ = rowsum(dO∘O), ds = p·(dP − Δ) times
    (1 − t²) under a softcap and the logit scale; dK and dV of a kv head
    are summed over its GQA group."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        z = softcap * t
    else:
        z = s
    mask = _mask(S, T, causal, window, q_offset, q.device)
    lse4 = lse.reshape(B, H, S, 1)
    p = torch.where(mask, torch.exp(torch.clamp(torch.where(mask, z, 0.0) - lse4, max=0.0)), 0.0)
    delta = (out.float() * dof).sum(-1).transpose(1, 2)[..., None]     # (B, H, S, 1)
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    ds = p * (dp - delta)
    if softcap > 0.0:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.einsum("bhst,bthd->bshd", ds, kf)
    dk = torch.einsum("bhst,bshd->bthd", ds, qf).reshape(B, T, Hkv, group, D).sum(3)
    dv = torch.einsum("bhst,bshd->bthd", p, dof).reshape(B, T, Hkv, group, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _mask(S: int, T: int, causal: bool, window: int, q_offset: int,
          device: torch.device) -> torch.Tensor:
    """(S, T) validity of (query, key): causal, sliding window, q_offset."""
    q_pos = torch.arange(S, device=device)[:, None] + q_offset
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def cross_entropy_ref(
    h: torch.Tensor,          # (T, D)
    w: torch.Tensor,          # (D, Vpad)
    targets: torch.Tensor,    # (T,) integer
    vocab: int = 0,           # true vocab (<= Vpad); 0 -> Vpad
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cross-entropy forward: (loss, lse), both (T,) fp32.

    The reference's ``_ce_kernel`` in one block: fp32 logits of the upcast
    operands, columns >= vocab masked to −1e30, lse = m + log(max(l,
    1e-30)), and the target logit as the max over the (masked) target
    column — a target outside [0, vocab) gives −1e30, as in the kernel."""
    vocab = vocab or w.shape[1]
    logits = h.float() @ w.float()
    col = torch.arange(w.shape[1], device=h.device)
    logits = torch.where(col < vocab, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True).clamp_min(1e-30)))[:, 0]
    hit = col[None, :] == targets.long()[:, None]
    tgt_logit = torch.where(hit, logits, NEG_INF).amax(dim=-1)
    return lse - tgt_logit, lse


def cross_entropy_bwd_ref(
    h: torch.Tensor,          # (T, D)
    w: torch.Tensor,          # (D, Vpad)
    targets: torch.Tensor,    # (T,) integer
    lse: torch.Tensor,        # (T,) fp32 forward residual
    g_loss: torch.Tensor,     # (T,) cotangent of the per-token loss
    g_lse: torch.Tensor,      # (T,) cotangent of the lse output
    vocab: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cross-entropy backward: (dh (T, D), dw (D, Vpad)) in the input
    dtypes, following the reference's ``_block_dlogits``: dlogits =
    (g_loss + g_lse)·p − g_loss·onehot in fp32, with p = exp(min(logit −
    lse, 0)) on valid columns; padded columns get exactly zero."""
    vocab = vocab or w.shape[1]
    hf, wf = h.float(), w.float()
    logits = hf @ wf
    col = torch.arange(w.shape[1], device=h.device)
    valid = col < vocab
    p = torch.where(valid, torch.exp(torch.clamp(
        torch.where(valid, logits, 0.0) - lse[:, None], max=0.0)), 0.0)
    onehot = valid & (col[None, :] == targets.long()[:, None])
    gl, gs = g_loss.float()[:, None], g_lse.float()[:, None]
    dlogits = (gl + gs) * p - gl * onehot
    return (dlogits @ wf.T).to(h.dtype), (hf.T @ dlogits).to(w.dtype)


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


def layernorm_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], dy: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """LayerNorm backward: (dx in x.dtype, dw and db in w's dtype; db None
    without a bias), the reference's ``_ln_bwd`` with the moments
    recomputed from x.  As there, ``dy * w`` is formed in the inputs'
    dtype (bf16 under the compute view) before the fp32 cast."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    dyw = (dy * w).float()
    c1 = dyw.mean(dim=-1, keepdim=True)
    c2 = (dyw * xhat).mean(dim=-1, keepdim=True)
    dx = ((dyw - c1 - xhat * c2) * rstd).to(x.dtype)
    dyf = dy.float()
    rows = tuple(range(x.dim() - 1))
    dw = (dyf * xhat).sum(dim=rows).to(w.dtype)
    db = None if b is None else dyf.sum(dim=rows).to(b.dtype)
    return dx, dw, db


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm over the last dim: fp32 mean of squares, output in
    x.dtype (the reference's ``ref.rmsnorm_ref``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm backward: (dx in x.dtype, dw in w's dtype), the reference's
    ``_rms_bwd`` with rstd recomputed from x.  As there, ``dy * w`` is
    formed in the inputs' dtype (bf16 under the compute view) before the
    fp32 cast."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    dyw = (dy * w).float()
    c = (dyw * xf).sum(dim=-1, keepdim=True) * (rstd * rstd) / x.shape[-1]
    dx = ((dyw - xf * c) * rstd).to(x.dtype)
    dw = (dy.float() * xf * rstd).sum(dim=tuple(range(x.dim() - 1)))
    return dx, dw.to(w.dtype)


def decode_attention_ref(
    q: torch.Tensor,          # (B, 1, H, D)
    k: torch.Tensor,          # (B, T, Hkv, D)
    v: torch.Tensor,          # (B, T, Hkv, D)
    lengths: torch.Tensor,    # (B,) valid cache length per row
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """One-token attention over a dense cache: (B, 1, H, D) in q.dtype.

    The reference's ``ops._decode_attention_xla``: the grouped-head form
    (query head h reads kv head h // group; the cache is never repeated),
    fp32 scores, keys at positions >= length masked, and a row with
    length 0 (an idle serving slot) gives exactly zeros.  As there, the
    normalized probabilities are rounded to q.dtype before the PV product,
    which accumulates in fp32."""
    B, _, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k.float()) * (1.0 / math.sqrt(D))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.arange(T, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(s - m))
    p = (p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", p.float(), v.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# --------------------------------------------------------------------- #
# paged KV cache: the page gather, attention through a block table, and the
# per-token insert
# --------------------------------------------------------------------- #
def _gather_pages(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(num_pages, page, Hkv, D) + (B, n) table -> dense (B, n·page, Hkv, D)."""
    B, n = block_table.shape
    return pool[block_table.reshape(-1).long()].reshape(B, n * pool.shape[1], *pool.shape[2:])


def paged_decode_attention_ref(
    q: torch.Tensor,            # (B, 1, H, D)
    k_pool: torch.Tensor,       # (num_pages, page, Hkv, D)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, pages_per_seq) physical page ids
    lengths: torch.Tensor,      # (B,) valid cache length per row
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """One-token attention through a block table: the pages gathered into a
    dense cache, then ``decode_attention_ref`` (the reference's XLA path of
    ``ops.paged_decode_attention``).  A row of length 0 gives zeros."""
    return decode_attention_ref(q, _gather_pages(k_pool, block_table),
                                _gather_pages(v_pool, block_table), lengths, softcap=softcap)


def paged_prefill_attention_ref(
    q: torch.Tensor,            # (B, S, H, D) chunk queries
    k_pool: torch.Tensor,       # (num_pages, page, Hkv, D)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, pages_per_seq)
    starts: torch.Tensor,       # (B,) position of each chunk's row 0
    lengths: torch.Tensor,      # (B,) valid context length (start + valid rows)
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Chunk attention through a block table: (B, S, H, D) in q.dtype.

    Query row i of batch b sits at position ``starts[b] + i`` and attends
    to the cache positions ``k <= starts[b] + i`` with ``k < lengths[b]``
    (the reference's XLA path of ``ops.paged_prefill_attention``): fp32
    scores, a fully masked row gives zeros, and the normalized
    probabilities are rounded to q.dtype before the PV product, which
    accumulates in fp32."""
    B, S, H, D = q.shape
    Hkv = k_pool.shape[2]
    k = _gather_pages(k_pool, block_table).float()        # (B, T, Hkv, D)
    v = _gather_pages(v_pool, block_table).float()
    T = k.shape[1]
    qg = q.reshape(B, S, Hkv, H // Hkv, D).float()
    s = torch.einsum("bshgd,bthd->bhgst", qg, k) * (1.0 / math.sqrt(D))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    q_pos = starts.to(dev).long()[:, None] + torch.arange(S, device=dev)[None, :]   # (B, S)
    k_pos = torch.arange(T, device=dev)
    mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
            & (k_pos[None, None, :] < lengths.to(dev).long()[:, None, None]))     # (B, S, T)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(s - m))
    p = (p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", p.float(), v)
    return out.reshape(B, S, H, D).to(q.dtype)


def paged_kv_write_ref(k_pool: torch.Tensor, v_pool: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, page_idx: torch.Tensor, row: torch.Tensor) -> None:
    """In place: ``pool[page_idx[b], row[b]] = new[b, 0]`` for K and V.
    k_new, v_new (B, 1, Hkv, D).  Idle slots all write to the null page 0,
    which holds no sequence; where two of them collide, either write may
    land."""
    idx = (page_idx.long(), row.long())
    k_pool.index_put_(idx, k_new[:, 0].to(k_pool.dtype))
    v_pool.index_put_(idx, v_new[:, 0].to(v_pool.dtype))


def paged_decode_append_ref(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                            block_table: torch.Tensor, lengths: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor, page_idx: torch.Tensor,
                            row: torch.Tensor, *, softcap: float = 0.0) -> torch.Tensor:
    """The paged decode step's insert and attention: ``paged_kv_write_ref``
    (in place) then ``paged_decode_attention_ref``, the reference's
    ``ops.paged_kv_update`` then ``ops.paged_decode_attention``."""
    paged_kv_write_ref(k_pool, v_pool, k_new, v_new, page_idx, row)
    return paged_decode_attention_ref(q, k_pool, v_pool, block_table, lengths, softcap=softcap)


# --------------------------------------------------------------------- #
# sampling: the counter-hash Gumbel noise and the bisection row math
# --------------------------------------------------------------------- #
_BISECT_ITERS = 32
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32): the product is split at
    16 bits so that no intermediate leaves int64's range."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_bits(seed: torch.Tensor, step: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The uint32 draw (as int64) of the reference's ``gumbel_noise`` for
    (seed, step) of shape (R, 1) and vocab ids idx (R, V); every input is
    taken mod 2^32."""
    h = fmix32((seed.long() + 0x9E3779B9) & _M32)
    h = fmix32(h ^ _mul32(step.long() & _M32, 0x85EBCA77))
    return fmix32(h ^ _mul32(idx.long() & _M32, 0x9E3779B1))


def gumbel_noise(seed: torch.Tensor, step: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise, a pure function of (seed, step, vocab id): the
    top 24 bits of the hash, +0.5, scaled into (0, 1), then -log(-log u),
    all in fp32 as in the reference."""
    u = ((hash_bits(seed, step, idx) >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_ref(
    logits: torch.Tensor,       # (B, V) any float dtype; masked entries -1e30
    temperature: torch.Tensor,  # (B,) <= 0: greedy
    top_k: torch.Tensor,        # (B,) 0 disables
    top_p: torch.Tensor,        # (B,) 1.0 disables
    seed: torch.Tensor,         # (B,) integer, taken mod 2^32
    step: torch.Tensor,         # (B,) integer generation index
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row temperature / top-k / top-p sampling: (tok (B,) int32,
    logp (B,) fp32).

    The reference's ``sampling._sample_rows`` over all rows at once: fp32
    z = x / t on the valid columns; thresholds for top-k (count) and top-p
    (mass) found by a 32-step bisection over [min z, max z + 1]; kept set
    z >= min(max(tau_k, tau_p), max z); Gumbel-max over the kept set with
    the counter-hash noise, the first index on ties.  A greedy row keeps
    every valid column and adds no noise, so its token is the first-index
    argmax.  logp is the chosen token's log-probability under the kept,
    temperature-scaled, renormalized distribution."""
    x = logits.float()
    B, V = x.shape
    dev = x.device
    temp = temperature.float()[:, None]
    valid = x > NEG_INF / 2
    greedy = temp <= 0.0
    z = torch.where(valid, x / torch.where(greedy, 1.0, temp), NEG_INF)
    m = z.amax(dim=-1, keepdim=True)
    mn = torch.where(valid, z, m).amin(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(z - m), 0.0)
    Z = e.sum(dim=-1, keepdim=True)
    tk = top_k.long()[:, None]
    k = torch.where(tk <= 0, V, tk.clamp(1, V)).float()
    pZ = top_p.float()[:, None].clamp(1e-9, 1.0) * Z
    lo_k, hi_k, lo_p, hi_p = mn, m + 1.0, mn, m + 1.0
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo_k + hi_k)
        ok = (z >= mid).float().sum(dim=-1, keepdim=True) >= k
        lo_k, hi_k = torch.where(ok, mid, lo_k), torch.where(ok, hi_k, mid)
        mid = 0.5 * (lo_p + hi_p)
        ok = torch.where(z >= mid, e, 0.0).sum(dim=-1, keepdim=True) >= pZ
        lo_p, hi_p = torch.where(ok, mid, lo_p), torch.where(ok, hi_p, mid)
    tau = torch.where(greedy, mn, torch.minimum(torch.maximum(lo_k, lo_p), m))
    idx = torch.arange(V, device=dev)[None, :]
    g = torch.where(greedy, 0.0, gumbel_noise(seed[:, None], step[:, None], idx))
    keep = valid & (z >= tau)
    y = torch.where(keep, z + g, NEG_INF)
    ymax = y.amax(dim=-1, keepdim=True)
    tok = torch.where(y == ymax, idx, V).amin(dim=-1, keepdim=True)
    z_tok = torch.gather(z, 1, tok.clamp_max(V - 1))
    Zf = torch.where(keep, e, 0.0).sum(dim=-1, keepdim=True)
    logp = z_tok - m - torch.log(Zf.clamp_min(1e-30))
    return tok[:, 0].to(torch.int32), logp[:, 0]


def _heap_midpoints(lo: torch.Tensor, hi: torch.Tensor, levels: int) -> torch.Tensor:
    """(R, 2^levels - 1): the midpoints of the next ``levels`` bisection
    steps from (lo, hi) of shape (R, 1), in heap order (column 0 the root,
    the children of column i at 2i + 1 and 2i + 2), each ``0.5 * (lo +
    hi)`` of its interval in fp32, as the sequential loop computes it."""
    los, his, mids = [lo], [hi], []
    for i in range((1 << levels) - 1):
        mid = 0.5 * (los[i] + his[i])
        mids.append(mid)
        los += [los[i], mid]
        his += [mid, his[i]]
    return torch.cat(mids, dim=1)


def sample_levels_ref(
    logits: torch.Tensor,       # (B, V) any float dtype; masked entries -1e30
    temperature: torch.Tensor,  # (B,) <= 0: greedy
    top_k: torch.Tensor,        # (B,) 0 disables
    top_p: torch.Tensor,        # (B,) 1.0 disables
    seed: torch.Tensor,         # (B,) integer, taken mod 2^32
    step: torch.Tensor,         # (B,) integer generation index
    levels: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``sample_ref`` with the bisection walked as ``csrc/sampling.cu``
    walks it: each pass evaluates all 2^levels - 1 midpoints of the next
    ``levels`` steps of each search (integer counts, masses) and then
    descends that many levels.  The midpoints and the descent are the
    sequential loop's, so the thresholds are its own (the top-k one bit for
    bit; the masses are summed in another order).  The top-k search is
    skipped where top-k is off, as the kernel skips it.  Returns (tok,
    logp, lo_k, lo_p), the thresholds (B,) fp32.  A definition for the
    tests, not a path of the port."""
    x = logits.float()
    B, V = x.shape
    temp = temperature.float()[:, None]
    valid = x > NEG_INF / 2
    greedy = temp <= 0.0
    z = torch.where(valid, x / torch.where(greedy, 1.0, temp), NEG_INF)
    m = z.amax(dim=-1, keepdim=True)
    mn = torch.where(valid, z, m).amin(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(z - m), 0.0)
    tk = top_k.long()[:, None]
    k = torch.where(tk <= 0, V, tk.clamp(1, V)).float()
    k_on = (tk > 0) & (tk < V)
    pZ = top_p.float()[:, None].clamp(1e-9, 1.0) * e.sum(dim=-1, keepdim=True)
    lo_k, hi_k, lo_p, hi_p = mn, m + 1.0, mn, m + 1.0
    for it in range(0, _BISECT_ITERS, levels):
        mk, mp = _heap_midpoints(lo_k, hi_k, levels), _heap_midpoints(lo_p, hi_p, levels)
        cnt = torch.stack([(z >= mk[:, j:j + 1]).sum(dim=-1) for j in range(mk.shape[1])], 1)
        mass = torch.stack([torch.where(z >= mp[:, j:j + 1], e, 0.0).sum(dim=-1)
                            for j in range(mp.shape[1])], 1)
        nk = torch.zeros((B, 1), dtype=torch.long)
        np_ = torch.zeros((B, 1), dtype=torch.long)
        for _ in range(min(levels, _BISECT_ITERS - it)):
            mid = 0.5 * (lo_k + hi_k)
            ok = cnt.gather(1, nk).float() >= k
            lo_k = torch.where(k_on & ok, mid, lo_k)
            hi_k = torch.where(k_on & ~ok, mid, hi_k)
            nk = 2 * nk + 1 + ok.long()
            mid = 0.5 * (lo_p + hi_p)
            ok = mass.gather(1, np_) >= pZ
            lo_p, hi_p = torch.where(ok, mid, lo_p), torch.where(ok, hi_p, mid)
            np_ = 2 * np_ + 1 + ok.long()
    tau = torch.where(greedy, mn, torch.minimum(torch.maximum(lo_k, lo_p), m))
    idx = torch.arange(V)[None, :]
    g = torch.where(greedy, 0.0, gumbel_noise(seed[:, None], step[:, None], idx))
    keep = valid & (z >= tau)
    y = torch.where(keep, z + g, NEG_INF)
    tok = torch.where(y == y.amax(dim=-1, keepdim=True), idx, V).amin(dim=-1, keepdim=True)
    z_tok = torch.gather(z, 1, tok.clamp_max(V - 1))
    Zf = torch.where(keep, e, 0.0).sum(dim=-1, keepdim=True)
    logp = z_tok - m - torch.log(Zf.clamp_min(1e-30))
    return tok[:, 0].to(torch.int32), logp[:, 0], lo_k[:, 0], lo_p[:, 0]


def grouped_matmul_ref(
    x: torch.Tensor,            # (M, K) rows sorted by group
    w: torch.Tensor,            # (E, K, N) per-group weights
    group_sizes: torch.Tensor,  # (E,) int contiguous row counts
) -> torch.Tensor:
    """Ragged grouped matmul ``y[i] = x[i] @ w[g(i)]`` -> (M, N) in x.dtype,
    fp32 products and sums; rows at or past ``sum(group_sizes)`` are
    exactly 0.  A static loop over the E groups, each a full (M, K) @ (K, N)
    product kept on its group's rows, which the prefix sum of the sizes
    picks on the device: the sizes are never read on the host, and the
    memory is O(M·N), where the reference's per-row weight gather is
    O(M·K·N).  E times the products of the kernel: a definition, not a
    yardstick of speed.  Differentiable."""
    M, N = x.shape[0], w.shape[2]
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    starts = ends - group_sizes.to(torch.int64)
    rows = torch.arange(M, device=x.device)
    xf = x.float()
    y = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for e in range(w.shape[0]):
        mine = ((rows >= starts[e]) & (rows < ends[e]))[:, None]
        y = torch.where(mine, xf @ w[e].float(), y)
    return y.to(x.dtype)


def grouped_matmul_dw_ref(
    x: torch.Tensor,            # (M, K) rows sorted by group
    dy: torch.Tensor,           # (M, N) output cotangent, same row order
    group_sizes: torch.Tensor,  # (E,) int contiguous row counts
) -> torch.Tensor:
    """Ragged weight gradient: ``dw[g] = x_gᵀ · dy_g`` over group g's
    contiguous rows -> (E, K, N) fp32, fp32 products and sums.  An empty
    group's slice is exactly 0 and rows at or past ``sum(group_sizes)``
    contribute nothing.  As ``grouped_matmul_ref``: a static loop over the
    groups, each a full (K, M) @ (M, N) product of x with its rows outside
    the group zeroed (in both operands) by a mask the prefix sum of the
    sizes picks on the device, so memory stays O(M·(K+N)) and the sizes are never read on the
    host."""
    M, K, N = x.shape[0], x.shape[1], dy.shape[1]
    E = group_sizes.shape[0]
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    starts = ends - group_sizes.to(torch.int64)
    rows = torch.arange(M, device=x.device)
    xf, dyf = x.float(), dy.float()
    dw = torch.empty((E, K, N), dtype=torch.float32, device=x.device)
    for e in range(E):
        mine = ((rows >= starts[e]) & (rows < ends[e]))[:, None]
        dw[e] = torch.where(mine, xf, 0.0).T @ torch.where(mine, dyf, 0.0)
    return dw


# --------------------------------------------------------------------- #
# Mamba-2 SSD, per head h with state (P, N):
#   h_t = exp(dt_t · A) h_{t-1} + dt_t · x_t B_tᵀ,   y_t = h_t C_t + D x_t
# --------------------------------------------------------------------- #
def _ssd_inputs(x, dt, A, Bm, Cm):
    """fp32 copies with B and C repeated over the heads of each group (the
    head axis is the second to last of x, B and C)."""
    rep = x.shape[-2] // Bm.shape[-2]
    return (x.float(), dt.float(), A.float(), Bm.float().repeat_interleave(rep, dim=-2),
            Cm.float().repeat_interleave(rep, dim=-2))


def ssd_scan_ref(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)  positive (softplus'd)
    A: torch.Tensor,      # (H,)       negative
    Bm: torch.Tensor,     # (B, S, G, N)
    Cm: torch.Tensor,     # (B, S, G, N)
    D: torch.Tensor,      # (H,)
    chunk: int = 64,
    states: bool = False,
):
    """The SSD kernel's math: the chunked dual form in fp32 -> (y (B, S, H,
    P) in x.dtype, final state (B, H, P, N) fp32), and with ``states`` also
    the state entering each chunk, (B, nc, H, P, N) fp32 (the first is
    zero), which ``ssd_scan_bwd_ref`` takes.  Per chunk of L rows,
    with ``cum`` the inclusive prefix sum of dt·A:

        att   = (C Bᵀ) ∘ exp(cum_t − cum_s)[s ≤ t] ∘ dt_s
        y     = att x + (C ∘ exp(cum)) h_inᵀ + D x
        h_out = h_in exp(cum_L) + (x ∘ dt ∘ exp(cum_L − cum))ᵀ B

    as the reference's ``_ssd_kernel`` computes it.  Any S: the last chunk
    is padded with x = 0, dt = 0, rows that add nothing to the state and do
    not decay it, so the final state is exact.  The causal decay is
    selected before the exponent, never multiplied by a mask: cum_t − cum_s
    for s > t is positive and may overflow, and inf · 0 is NaN (in the
    gradient too).  Differentiable."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    xf, dtf, Af, Bf, Cf = _ssd_inputs(x, dt, A, Bm, Cm)
    L = min(chunk, S)
    pad = -S % L

    def padded(t):
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    xf, dtf, Bf, Cf = padded(xf), padded(dtf), padded(Bf), padded(Cf)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys, h_in = [], []
    for c0 in range(0, S + pad, L):
        h_in.append(h)
        xc, dtc, bc, cc = (t[:, c0:c0 + L] for t in (xf, dtf, Bf, Cf))
        cum = torch.cumsum(dtc * Af, dim=1)                       # (B, L, H)
        seg = cum[:, -1]                                           # (B, H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]             # (B, L, L, H)
        decay = torch.exp(diff.masked_fill(~causal, -math.inf))
        att = torch.einsum("blhn,bshn->blsh", cc, bc) * decay * dtc[:, None]
        y = torch.einsum("blsh,bshp->blhp", att, xc)
        y = y + torch.einsum("blhn,bhpn->blhp", cc * torch.exp(cum)[..., None], h)
        xw = xc * (dtc * torch.exp(seg[:, None] - cum))[..., None]
        h = h * torch.exp(seg)[..., None, None] + torch.einsum("blhp,blhn->bhpn", xw, bc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S] + xf[:, :S] * D.float()[None, None, :, None]
    if states:
        return y.to(x.dtype), h, torch.stack(h_in, dim=1)
    return y.to(x.dtype), h


def ssd_scan_bwd_ref(
    x: torch.Tensor,       # (B, S, H, P)
    dt: torch.Tensor,      # (B, S, H)
    A: torch.Tensor,       # (H,)
    Bm: torch.Tensor,      # (B, S, G, N)
    Cm: torch.Tensor,      # (B, S, G, N)
    D: torch.Tensor,       # (H,)
    states: torch.Tensor,  # (B, nc, H, P, N) fp32: the state entering each chunk
    dy: torch.Tensor,      # (B, S, H, P)
    dstate: Optional[torch.Tensor] = None,   # (B, H, P, N): the final state's gradient
    chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """The SSD scan's backward in its chunked form, in fp32 -> (dx in
    x.dtype, ddt fp32, dA in A.dtype, dB and dC in Bm.dtype, dD in D.dtype),
    the decomposition the backward kernel computes.  ``states`` are
    ``ssd_scan_ref(..., states=True)``'s at the same ``chunk``.

    A reverse pass over the chunks carries the state's gradient dh: the
    last chunk's dh_out is ``dstate`` (or 0), and dh_in = exp(seg) dh_out +
    Σ_t exp(cum_t) dy_t C_tᵀ.  Given each chunk's h_in and dh_out the
    chunks are independent.  Per chunk, head and batch row, with rows t ≥ s,
    G = C Bᵀ, E_ts = exp(cum_t − cum_s), M = G ∘ E ∘ dt_s, w_s = dt_s
    exp(seg − cum_s) and dM = dy xᵀ:

        dx_s  = Σ_t M_ts dy_t + w_s (dh_out B_s) + D dy_s
        dB_s  = Σ_t dM_ts E_ts dt_s C_t + w_s (dh_outᵀ x_s)
        dC_t  = Σ_s dM_ts E_ts dt_s B_s + exp(cum_t) (h_inᵀ dy_t)
        ddt_s = Σ_t dM_ts G_ts E_ts + dw_s exp(seg − cum_s) + A rc_s
        dA    = Σ dt_r rc_r,   dD = Σ dy·x

    where dw_s = x_sᵀ dh_out B_s, rc_r = Σ_{t≥r} dcum_t, and with Q = dM ∘
    M: dcum_t = Σ_s Q_ts − Σ_t' Q_t't + exp(cum_t) dy_t·(h_in C_t) − dw_t
    w_t, the last row adding Σ_s dw_s w_s + exp(seg) ⟨dh_out, h_in⟩.  dB
    and dC sum over the heads of a group.  The causal decay is selected
    before the exponent, as in the forward.  The padded tail (x = 0, dt = 0,
    dy = 0) adds nothing."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xf, dtf, Af, Bf, Cf = _ssd_inputs(x, dt, A, Bm, Cm)
    L = min(chunk, S)
    pad = -S % L
    nc = (S + pad) // L
    if states.shape != (Bsz, nc, H, P, N):
        raise ValueError(f"ssd_scan_bwd_ref: states must be {(Bsz, nc, H, P, N)} for chunk "
                         f"{chunk}; got {tuple(states.shape)}")

    def chunked(t):   # (B, S, H, ...) -> (B, nc, L, H, ...), the tail zero-padded
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, nc, L, *t.shape[2:])

    xc, dtc, bc, cc, dyc = (chunked(t) for t in (xf, dtf, Bf, Cf, dy.float()))
    h_in = states.float()
    cum = torch.cumsum(dtc * Af, dim=2)                                  # (B, nc, L, H)
    seg = cum[:, :, -1]                                                  # (B, nc, H)
    ecum = torch.exp(cum)
    # the reverse pass: each chunk's dh_out
    U = torch.einsum("bclhp,bclhn->bchpn", ecum[..., None] * dyc, cc)
    dh_out = torch.empty_like(h_in)
    carry = (torch.zeros_like(h_in[:, 0]) if dstate is None else dstate.float())
    for c in range(nc - 1, -1, -1):
        dh_out[:, c] = carry
        carry = torch.exp(seg[:, c])[..., None, None] * carry + U[:, c]
    # the chunks' own gradients, all chunks at once; index order (t, s)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()[:, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]                 # (B, nc, L, L, H)
    E = torch.exp(diff.masked_fill(~causal, -math.inf))
    dts = dtc[:, :, None]                                                # dt_s
    Gm = torch.einsum("bcthn,bcshn->bctsh", cc, bc)
    dM = torch.einsum("bcthp,bcshp->bctsh", dyc, xc)
    M = Gm * E * dts
    dS = dM * E * dts
    R = dM * Gm * E
    w = dtc * torch.exp(seg[:, :, None] - cum)                           # (B, nc, L, H)
    dhB = torch.einsum("bchpn,bcshn->bcshp", dh_out, bc)
    dx = torch.einsum("bctsh,bcthp->bcshp", M, dyc) + w[..., None] * dhB
    V = torch.einsum("bchpn,bcshp->bcshn", dh_out, xc)                   # dh_outᵀ x_s
    dBh = torch.einsum("bctsh,bcthn->bcshn", dS, cc) + w[..., None] * V
    Z = torch.einsum("bchpn,bcthp->bcthn", h_in, dyc)                    # h_inᵀ dy_t
    dCh = torch.einsum("bctsh,bcshn->bcthn", dS, bc) + ecum[..., None] * Z
    dw = (bc * V).sum(-1)                                                # (B, nc, L, H)
    Q = R * dts
    dcum = Q.sum(3) - Q.sum(2) + ecum * (cc * Z).sum(-1) - dw * w
    dcum[:, :, -1] += (dw * w).sum(2) + torch.exp(seg) * (dh_out * h_in).sum((-2, -1))
    rc = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])        # Σ_{t ≥ r} dcum_t
    ddt = R.sum(2) + dw * torch.exp(seg[:, :, None] - cum) + Af * rc
    dA = (dtc * rc).sum((0, 1, 2))

    def unchunked(t):
        return t.reshape(Bsz, nc * L, *t.shape[3:])[:, :S]

    dx = unchunked(dx) + dy.float() * D.float()[None, None, :, None]
    dD = (dy.float() * xf).sum((0, 1, 3))
    rep = H // G
    dB = unchunked(dBh).reshape(Bsz, S, G, rep, N).sum(3)
    dC = unchunked(dCh).reshape(Bsz, S, G, rep, N).sum(3)
    return (dx.to(x.dtype), unchunked(ddt).to(dt.dtype), dA.to(A.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype),
            dD.to(D.dtype))


def ssd_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    D: torch.Tensor, init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential-scan oracle, one row at a time in fp32 -> (y (B, S,
    H, P) in x.dtype, final state (B, H, P, N) fp32).  Shapes as
    ``ssd_scan_ref``."""
    Bsz, S, H, P = x.shape
    xf, dtf, Af, Bf, Cf = _ssd_inputs(x, dt, A, Bm, Cm)
    h = (torch.zeros((Bsz, H, P, Bm.shape[3]), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]                      # (B, H, 1, 1)
        h = h * decay + (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode_step_ref(
    x: torch.Tensor,       # (B, 1, H, P)
    dt: torch.Tensor,      # (B, 1, H)
    A: torch.Tensor,       # (H,)
    Bm: torch.Tensor,      # (B, 1, G, N)
    Cm: torch.Tensor,      # (B, 1, G, N)
    D: torch.Tensor,       # (H,)
    state: torch.Tensor,   # (B, H, P, N) fp32, updated in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step (serving) -> (y (B, 1, H, P) in x.dtype,
    state).  The state is advanced in place — the engine's cache holds it —
    where the reference returns a new array: a decay pass and an
    outer-product pass, each reading and writing the state, then one read
    for y."""
    xf, dtf, Af, Bf, Cf = _ssd_inputs(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    state.mul_(torch.exp(dtf * Af)[..., None, None])
    state.addcmul_((dtf[..., None] * xf)[..., :, None], Bf[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Cf) + xf * D.float()[None, :, None]
    return y[:, None].to(x.dtype), state
