"""AdamW, written out (the port's copy of the reference's ``optim/adamw.py``).

Not ``torch.optim.AdamW``: the reference adds eps to the bias-corrected
second-moment root, m̂/(√v̂ + eps), and applies decay inside the update as
lr·(m̂/(√v̂ + eps) + wd·p), where ``torch.optim.AdamW`` decays p by lr·wd
before its step and puts eps elsewhere.  Decay applies to leaves with
``ndim >= 2`` only, as in the reference — which includes the stacked
(num_layers, d) norm scales and biases, and leaves out the final norm.

The port updates params and moments in place, one leaf at a time and
each leaf in flat chunks of ``CHUNK`` elements, so the update's fp32
temporaries are a few chunks' worth, not a few leaves' (Llama-4's
embedding and head are 1.03 G elements each); the clip scales the
gradients in place.  The elementwise math is the same whatever the
chunking, so the bits are too.  The optional ``ok`` flag (a device bool)
keeps the old values where it is false, so a guarded step needs no host
sync.

On a mesh the params, gradients and moments are each rank's shards (the
leaves keep their dims: a shard of a 2-D leaf is 2-D, so the decay rule
reads the global leaf's ``ndim``), the update is elementwise on them, and
``global_norm`` sums each distinct element once across the ranks.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.config import TrainConfig
from repro_torch.core.module import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any
    nu: Any


def init_state(params: Any, state_dtype: torch.dtype = torch.float32) -> AdamWState:
    z = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return AdamWState(step=step, mu=tree_map(z, params), nu=tree_map(z, params))


CHUNK = 1 << 22   # elements of a leaf updated at a time (16 MB in fp32)


@torch.no_grad()
def apply_updates(params: Any, grads: List[torch.Tensor], state: AdamWState,
                  lr: torch.Tensor, tc: TrainConfig,
                  ok: Optional[torch.Tensor] = None) -> AdamWState:
    """One AdamW step, in place on ``params`` and the moments.  ``grads``
    follow ``tree_leaves(params)``.  Returns the new state (its step
    advanced, unless ``ok`` is false)."""
    step = state.step + 1
    b1, b2 = tc.beta1, tc.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    leaves = zip(tree_leaves(params), grads, tree_leaves(state.mu), tree_leaves(state.nu))
    for p, g, m, n in leaves:
        decay = tc.weight_decay > 0 and p.dim() >= 2   # no decay on vectors
        flat = [t.reshape(-1) for t in (p, g, m, n)]
        for i in range(0, p.numel(), CHUNK):
            p_c, g_c, m_c, n_c = (t[i:i + CHUNK] for t in flat)
            gf = g_c.float()
            m_new = b1 * m_c.float() + (1 - b1) * gf
            n_new = b2 * n_c.float() + (1 - b2) * gf * gf
            delta = (m_new / c1) / (torch.sqrt(n_new / c2) + tc.eps)
            if decay:
                delta = delta + tc.weight_decay * p_c.float()
            p_new = p_c.float() - lr * delta
            for old, new in ((p_c, p_new), (m_c, m_new), (n_c, n_new)):
                new = new.to(old.dtype)
                old.copy_(new if ok is None else torch.where(ok, new, old))
    if ok is not None:
        step = torch.where(ok, step, state.step)
    return AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(grads: List[torch.Tensor], ctx: Any = None,
                owned: Optional[List[bool]] = None) -> torch.Tensor:
    """‖g‖ in fp32, each leaf's squared sum (over its elements in row-major
    order, whatever the gradient's strides) added in leaf order.  On a mesh
    (``ctx``, with ``owned[i]`` true where this rank counts leaf i's shard:
    ``ShardingCtx.owns``) the per-leaf sums of the owned shards are
    all-reduced over every rank first, so a leaf sharded over an axis is
    summed over it and a leaf replicated over an axis is counted once; the
    leaves are then added in the same order as off the mesh."""
    def sq(g):
        return torch.sum(torch.square(g.float().contiguous()))

    if ctx is None:
        return torch.sqrt(sum(sq(g) for g in grads))
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    sums = torch.stack([sq(g) if o else zero for g, o in zip(grads, owned)])
    sums = ctx.all_reduce(sums, tuple(ctx.sizes))
    return torch.sqrt(sum(sums.unbind(0)))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, ctx: Any = None,
                        owned: Optional[List[bool]] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(grads scaled by min(1, max_norm / ‖g‖), ‖g‖), the norm in fp32
    (``global_norm``, over the mesh given ``ctx`` and ``owned``).
    The list's tensors are scaled in place (a tensor that shares its memory
    with an earlier one, or is not contiguous, is copied first, so nothing
    is scaled twice) and the list is returned."""
    gn = global_norm(grads, ctx, owned)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    seen = set()
    for i, g in enumerate(grads):
        if g.data_ptr() in seen or not g.is_contiguous():
            grads[i] = g.contiguous().clone()
        seen.add(grads[i].data_ptr())
    for g in grads:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:   # the product in fp32, rounded once, as the out-of-place form
            g.copy_(g.float() * scale)
    return grads, gn
