"""Weight bridge between the reference package's param tree and the port.

Both packages use the same nested-dict paths and shapes — the stacked
``layers`` dimension included — and the same ``x @ W`` layout (``wq`` is
``(d, H·hd)``), so a leaf crosses unchanged: no transpose, no reshape.

The reference side is a tree of numpy arrays (``jax.device_get`` of its
params).  A bfloat16 leaf (``dtype.name == "bfloat16"``) crosses as its raw
16-bit pattern, so the round trip is bit-exact without importing a numpy
bfloat16 type here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.module import tree_map


def _to_torch(a: Any) -> torch.Tensor:
    a = np.array(a, order="C")   # a C-ordered copy that keeps a 0-d leaf 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Reference param tree (numpy leaves) -> the port's tree of CPU tensors."""
    return tree_map(_to_torch, tree)


def to_jax_params(params: Dict[str, Any], bfloat16: Optional[np.dtype] = None
                  ) -> Dict[str, Any]:
    """The port's tree -> numpy leaves in the reference's layout.

    A bfloat16 tensor comes back as its raw bits viewed as ``bfloat16``,
    the numpy dtype the caller passes (``jnp.dtype(jnp.bfloat16)`` on the
    reference side); without it, as raw ``uint16``."""

    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return bits.view(bfloat16) if bfloat16 is not None else bits
        return t.numpy()

    return tree_map(one, params)
