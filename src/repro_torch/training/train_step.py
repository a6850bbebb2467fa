"""The train step: loss + grad + clip + AdamW (the port's copy of the
reference's ``training/train_step.py``, single device).

``make_train_step(model, tc)`` returns ``step_fn(state, batch) -> (state,
metrics)``:

* mixed precision — the forward and backward run on the compute-dtype view
  of the fp32 master params (``compute_view``, one cast per step under
  autograd); gradients land in the master dtype and AdamW updates the fp32
  copy;
* gradient accumulation — ``tc.accum_steps > 1`` runs the microbatches one
  after another with fp32 grad accumulators, each weighted by its token
  count, so ``accum=N`` matches one N×-larger batch for the masked-mean
  loss; the aux loss and an MoE model's router metrics are averaged over
  the microbatches;
* the first update uses step 1 of the lr schedule;
* non-finite guard — a step whose loss or grad norm is not finite applies
  no update: params and moments keep their old values through
  ``torch.where`` on the device (no host sync) and the optimizer step does
  not advance; ``metrics["skipped"]`` counts it.

The step updates ``state`` in place and returns it with device-side
metrics (0-dim tensors); nothing in it waits for the device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.config import ParallelConfig, TrainConfig
from repro_torch.core.module import tree_leaves, tree_map
from repro_torch.core.precision import compute_view, dtype_of
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.schedule import lr_at


class TrainState:
    """Params (the fp32 master tree) + AdamW state."""

    def __init__(self, params: Dict[str, Any], opt: adamw.AdamWState):
        self.params = params
        self.opt = opt

    def clone(self) -> "TrainState":
        """A deep copy on the same device (params keep requires_grad)."""
        c = lambda t: t.detach().clone().requires_grad_(t.requires_grad)  # noqa: E731
        return TrainState(tree_map(c, self.params), adamw.AdamWState(
            step=self.opt.step.clone(), mu=tree_map(c, self.opt.mu), nu=tree_map(c, self.opt.nu)))


def init_train_state(model: Model, pc: Optional[ParallelConfig] = None) -> TrainState:
    """The model's own parameters as the master copy (training updates the
    model in place) and zero AdamW moments in ``pc.optimizer_state_dtype``."""
    pc = pc or ParallelConfig()
    params = model.params.tree()
    return TrainState(params, adamw.init_state(params, dtype_of(pc.optimizer_state_dtype)))


def _split_micro(batch: Dict[str, torch.Tensor], accum: int) -> List[Dict[str, torch.Tensor]]:
    """(B, …) -> accum microbatches of (B/accum, …)."""
    for k, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"global batch {x.shape[0]} ({k}) not divisible by "
                             f"accum_steps {accum}")
    return [{k: x.reshape(accum, x.shape[0] // accum, *x.shape[1:])[i] for k, x in batch.items()}
            for i in range(accum)]


def make_train_step(model: Model, tc: TrainConfig):
    """Returns step_fn(state, batch) -> (state, metrics); see the module
    docstring."""
    accum = max(int(tc.accum_steps), 1)
    policy = model.policy
    # averaged over the microbatches: aux (0 for the dense stack) and an MoE
    # model's router metrics
    means = ("aux_loss",) + (("router_entropy", "router_drop_frac", "router_load")
                             if model.cfg.num_experts else ())

    def loss_and_grads(params, mb) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List]:
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(compute_view(policy, params), mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        for p in tree_leaves(params):
            p.requires_grad_(True)
        if accum == 1:
            loss, metrics, grads = loss_and_grads(params, batch)
            metrics["loss"] = loss
        else:
            # token-weighted: loss/ce average over tokens, `means` over the
            # microbatches
            g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(params)]
            acc = None
            for mb in _split_micro(batch, accum):
                loss, m, grads = loss_and_grads(params, mb)
                d = m["tokens"].float()
                for a, g in zip(g_acc, grads):
                    a.add_(d * g.float())
                upd = {"loss": d * loss, "ce_loss": d * m["ce_loss"], "tokens": d,
                       **{k: m[k] / accum for k in means}}
                acc = upd if acc is None else {k: acc[k] + v for k, v in upd.items()}
                del grads
            d_acc = acc["tokens"]
            grads = [a.div_(d_acc).to(p.dtype) for a, p in zip(g_acc, tree_leaves(params))]
            del g_acc
            metrics = dict(acc, loss=acc["loss"] / d_acc, ce_loss=acc["ce_loss"] / d_acc)
        grads, gnorm = adamw.clip_by_global_norm(grads, tc.grad_clip)
        lr = lr_at(tc, state.opt.step + 1)  # first update uses step 1 (warmup > 0)
        ok = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        state.opt = adamw.apply_updates(params, grads, state.opt, lr, tc, ok=ok)
        metrics.update(grad_norm=gnorm, lr=lr, skipped=(~ok).float())
        return state, metrics

    return step_fn
