"""The train step: loss + grad + clip + AdamW (the port's copy of the
reference's ``training/train_step.py``).

``make_train_step(model, tc)`` returns ``step_fn(state, batch) -> (state,
metrics)``:

* mixed precision — the forward and backward run on the compute-dtype view
  of the fp32 master params (``Model.compute_params``, one cast per step
  under autograd); gradients land in the master dtype and AdamW updates the fp32
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

On a mesh (a model built with one, ``build_model(cfg, pc, mesh)``) the same
``make_train_step`` makes the sharded step, the twin of the reference's
``make_sharded_train_step``: the master params and the moments are this
rank's shards (FSDP over ``pc.fsdp_axes``), ``Model.compute_params``
gathers their compute view (whole, once a step), the batch holds this
rank's rows, ``loss_fn`` is the global mean, the gradients come back
reduce-scattered in fp32 to their shards, and the global norm, the clip and
AdamW run on the shards.  Placement is rank-local slicing:
``state_shardings`` gives each leaf's spec and this rank's block of it,
``host_batch_sharding`` the batch's.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.config import ParallelConfig, TrainConfig
from repro_torch.core.module import tree_leaves, tree_map
from repro_torch.core.precision import dtype_of
from repro_torch.models.model import Model, param_defs
from repro_torch.parallel.sharding import Spec, shard_slices, spec
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
    model in place) and zero AdamW moments in ``pc.optimizer_state_dtype``
    (``pc`` defaults to the model's)."""
    pc = pc or model.pc
    params = model.params.tree()
    return TrainState(params, adamw.init_state(params, dtype_of(pc.optimizer_state_dtype)))


def abstract_train_state(model: Model) -> TrainState:
    """The TrainState's global shapes and dtypes, as ``meta`` tensors."""
    pdt = model.policy.pdt
    sdt = dtype_of(model.pc.optimizer_state_dtype)
    defs = param_defs(model.cfg)
    meta = lambda dt: (lambda p: torch.empty(p.shape, dtype=dt, device="meta"))  # noqa: E731
    return TrainState(tree_map(meta(pdt), defs), adamw.AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=tree_map(meta(sdt), defs), nu=tree_map(meta(sdt), defs)))


def train_state_specs(model: Model) -> TrainState:
    """Each leaf's logical spec on the model's mesh (the reference's
    ``param_specs``; () off the mesh)."""
    pspecs = tree_map(lambda p: model.ctx.sp(*p.axes), param_defs(model.cfg))
    return TrainState(pspecs, adamw.AdamWState(step=(), mu=pspecs, nu=pspecs))


class Placement(NamedTuple):
    """A leaf's place on the mesh: its fitted spec and this rank's block."""

    spec: Spec
    index: Tuple[slice, ...]


def state_shardings(model: Model) -> TrainState:
    """Where each leaf of the TrainState lives: its fitted spec (the master
    copy's) and this rank's block of the whole leaf."""
    ctx = model.ctx
    defs = param_defs(model.cfg)

    def place(p, ls):
        store = ls.store if ls is not None else ()
        return Placement(store, shard_slices(p.shape, store, ctx.sizes, ctx.coords))

    specs = model.specs if model.specs is not None else tree_map(lambda p: None, defs)
    placed = _map2(place, defs, specs)
    return TrainState(placed, adamw.AdamWState(step=Placement((), ()), mu=placed, nu=placed))


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def host_batch_sharding(model: Model) -> Spec:
    """A host batch's leading (row) dim over the mesh's batch axes, the
    rest replicated; a rank keeps its rows (``ShardingCtx.batch_rows``)."""
    return spec(model.ctx.rules, "batch") if model.sharded else ()


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
    # averaged over the microbatches: aux (0 for the dense stack) and an MoE
    # model's router metrics
    means = ("aux_loss",) + (("router_entropy", "router_drop_frac", "router_load")
                             if model.cfg.num_experts else ())
    ctx = model.ctx if model.sharded else None
    owned = [ctx.owns(ls.store) for ls in tree_leaves(model.specs)] if ctx else None

    def loss_and_grads(params, mb) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List]:
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(model.compute_params(params), mb)
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
        grads, gnorm = adamw.clip_by_global_norm(grads, tc.grad_clip, ctx, owned)
        lr = lr_at(tc, state.opt.step + 1)  # first update uses step 1 (warmup > 0)
        ok = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        state.opt = adamw.apply_updates(params, grads, state.opt, lr, tc, ok=ok)
        metrics.update(grad_norm=gnorm, lr=lr, skipped=(~ok).float())
        return state, metrics

    return step_fn
