"""LoRA fine-tuning (the port's copy of the reference's
``training/lora.py``): adapt a frozen base model through low-rank A/B
pairs on chosen weights.

The adapters live in a tree of their own, apart from the frozen base
params: the base stays untouched, the optimizer holds states for the
adapters only, and merging is an explicit, functional step.

    adapters = lora.init_adapters(base, rank=8, generator=g)
    loss_fn  = lora.make_lora_loss(model, base)
    loss, _  = loss_fn(adapters, batch)   # grads reach A, B and alpha only

The tree is ``{"alpha": 0-d fp32 tensor, "weights": {"layers/sub0/attn/wq":
{"A": (layers, din, r), "B": (layers, r, dout)}, …}}`` — A/B stacked like
the weight they adapt.  ``alpha`` is a leaf like the others, so a
gradient step over the whole tree (``optim/adamw.apply_updates``) trains
it too, as the reference's ``jax.value_and_grad`` over its adapter tree
does; ``count_trainable`` counts the A/B weights only.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.module import tree_map
from repro_torch.models.model import Model

DEFAULT_TARGETS = ("wq", "wv")


def _walk(tree: Any, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def target_paths(params: Any, targets: Tuple[str, ...] = DEFAULT_TARGETS
                 ) -> List[Tuple[str, ...]]:
    """Paths of the 2-D (or layer-stacked 3-D) weights whose leaf name is
    one of ``targets``, sorted."""
    return sorted(path for path, leaf in _walk(params)
                  if path[-1] in targets and getattr(leaf, "ndim", 0) in (2, 3))


def init_adapters(base_params: Any, rank: int = 8, alpha: float = 16.0,
                  targets: Tuple[str, ...] = DEFAULT_TARGETS, *,
                  generator: torch.Generator) -> Dict[str, Any]:
    """An A/B pair for each target weight, on the generator's device: A ~
    N(0, 1)/√r, drawn in target-path order, and B = 0, so the adapted model
    starts as the base."""
    dev = generator.device
    adapters: Dict[str, Any] = {
        "alpha": torch.tensor(alpha, dtype=torch.float32, device=dev), "weights": {}}
    for path in target_paths(base_params, targets):
        leaf = base_params
        for k in path:
            leaf = leaf[k]
        lead = tuple(leaf.shape[:-2])       # (layers,) for a stacked weight
        din, dout = leaf.shape[-2], leaf.shape[-1]
        A = torch.randn((*lead, din, rank), generator=generator, dtype=torch.float32,
                        device=dev) / math.sqrt(rank)
        B = torch.zeros((*lead, rank, dout), dtype=torch.float32, device=dev)
        adapters["weights"]["/".join(path)] = {"A": A, "B": B}
    return adapters


def merged_params(base_params: Any, adapters: Dict[str, Any]) -> Any:
    """Functional merge: W' = (W + (alpha/r)·A·B) in fp32, cast back to W's
    dtype; the other leaves are the base's own tensors."""
    alpha = adapters["alpha"]
    wmap = adapters["weights"]

    def merge(tree, path=()):
        if isinstance(tree, dict):
            return {k: merge(v, path + (k,)) for k, v in tree.items()}
        key = "/".join(path)
        if key not in wmap:
            return tree
        A, B = wmap[key]["A"], wmap[key]["B"]
        delta = torch.matmul(A, B) * (alpha / A.shape[-1])
        return (tree.float() + delta).to(tree.dtype)

    return merge(base_params)


def make_lora_loss(model: Model, base_params: Any):
    """``loss(adapters, batch) -> (loss, metrics)``: the model's loss on the
    merged params.  The base leaves are detached, so a gradient reaches
    the adapters only."""
    base = tree_map(lambda t: t.detach(), base_params)

    def loss_fn(adapters: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return model.loss_fn(merged_params(base, adapters), batch)

    return loss_fn


def count_trainable(adapters: Dict[str, Any]) -> int:
    """The A/B values (alpha not counted)."""
    return sum(x.numel() for _, x in _walk(adapters["weights"]))
