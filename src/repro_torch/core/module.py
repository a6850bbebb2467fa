"""Parameter definitions and their materialization.

A model is described as a nested dict of :class:`P` (param defs), the same
tree and the same dict paths as the reference package, so weights cross
between the two by path (``checkpoint/bridge.py``).  ``materialize``
draws each leaf from its own ``torch.Generator`` seeded from the model
seed and the leaf's path: the same seed gives the same weights on the same
device, whatever order the leaves are built in.  It does not reproduce the
reference's JAX init — the two packages are compared on bridged weights,
never on two independent inits.

``ParamTree`` holds a materialized tree as an ``nn.Module``: a dict node is
a submodule and a leaf an ``nn.Parameter``, so ``.to()``, ``state_dict()``
and ``parameters()`` work, and ``tree()`` hands the layers the plain nested
dict they take.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.precision import dtype_of


@dataclass(frozen=True)
class P:
    """Single parameter definition."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"   # fan_in | normal | zeros | ones | ssm_a | ssm_dt_bias
    fan_in: int = 0        # for "fan_in" init; 0 -> infer from shape[-2] or shape[0]
    scale: float = 0.02    # for "normal" init
    dtype: Optional[str] = None

    def std(self) -> float:
        """Standard deviation of the normal draw ("fan_in" / "normal")."""
        if self.init == "normal":
            return self.scale
        if self.init == "fan_in":
            fi = self.fan_in or (self.shape[-2] if len(self.shape) >= 2 else self.shape[0])
            return 1.0 / math.sqrt(max(fi, 1))
        raise ValueError(f"unknown init {self.init!r}")


def stacked(p: P, n: int) -> P:
    """Prepend a stacked ``layers`` dimension to a param def."""
    return P(
        shape=(n, *p.shape),
        axes=("layers", *p.axes),
        init=p.init,
        fan_in=p.fan_in or (p.shape[-2] if len(p.shape) >= 2 else p.shape[0]),
        scale=p.scale,
        dtype=p.dtype,
    )


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_get(tree: Any, path: Tuple[str, ...]) -> Any:
    """The node of a nested dict at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict in sorted-key order (the reference's
    ``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def stack_tree(tree: Dict[str, Any], n: int) -> Dict[str, Any]:
    return tree_map(lambda p: stacked(p, n), tree)


def _leaf_seed(seed: int, path: Tuple[str, ...]) -> int:
    # crc32, not hash(): str hashing is salted per process
    return (seed * 1_000_003 + zlib.crc32("/".join(path).encode())) % (2**63)


def _ssm_a(u: torch.Tensor) -> torch.Tensor:
    """Mamba-2's A = -u, u uniform in [1, 16): every head decays (A < 0);
    a fan-in normal draw would give some heads A > 0, whose state grows
    as exp(dt·A·t) and overflows fp32 within a long prompt."""
    return -(1.0 + 15.0 * u)


def _ssm_dt_bias(u: torch.Tensor) -> torch.Tensor:
    """softplus⁻¹(dt) for dt log-uniform in [1e-3, 1e-1]: the bias puts
    each head's initial step size in that range."""
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return dt + torch.log(-torch.expm1(-dt))


# the reference's ``ssm_defs`` init callables, as named draws from U[0, 1)
_SSM_INITS = {"ssm_a": _ssm_a, "ssm_dt_bias": _ssm_dt_bias}


def materialize(defs: Dict[str, Any], seed: int, param_dtype: torch.dtype,
                device: torch.device,
                keep: Optional[Callable[[Tuple[str, ...], torch.Tensor], torch.Tensor]] = None
                ) -> Dict[str, Any]:
    """Instantiate a P-tree into a nested dict of tensors on ``device``.
    ``keep(path, leaf)``, when given, takes each whole leaf as soon as it is
    drawn and returns what the tree keeps of it (a mesh rank's shard), so
    one whole leaf at a time is alive."""

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        leaf = draw(tree, path)
        return keep(path, leaf) if keep is not None else leaf

    def draw(tree, path):
        dt = dtype_of(tree.dtype) if tree.dtype else param_dtype
        if tree.init == "zeros":
            return torch.zeros(tree.shape, dtype=dt, device=device)
        if tree.init == "ones":
            return torch.ones(tree.shape, dtype=dt, device=device)
        g = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
        if tree.init in _SSM_INITS:
            u = torch.rand(tree.shape, generator=g, dtype=torch.float32, device=device)
            return _SSM_INITS[tree.init](u).to(dt)
        x = torch.randn(tree.shape, generator=g, dtype=torch.float32, device=device)
        # scaled in place: the same bits as ``x * std``, with one fp32
        # temporary of the leaf alive instead of two
        return x.mul_(tree.std()).to(dt)

    return build(defs)


class ParamTree(nn.Module):
    """A nested dict of tensors held as modules (dict nodes) and trainable
    parameters (leaves), keyed by the same paths.  Serving runs under
    ``torch.inference_mode``, so the leaves' ``requires_grad`` costs it
    nothing; the train step differentiates through them."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=v.is_floating_point()))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out
