"""Mixed-precision policy (BioNeMo/Megatron convention).

Parameters are stored in ``param_dtype`` (fp32 master by default), compute
runs in ``compute_dtype`` (bf16): ``compute_view`` casts the whole master
tree to the compute dtype once per train step, and every weight is cast to
the activation dtype where it enters a matmul, so the residual stream stays
in it.  Norms, RoPE, attention internals and pooling run in fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass(frozen=True)
class Policy:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def pdt(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdt(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def compute_view(policy: Policy, params: Any) -> Any:
    """Compute-dtype view of the master params (Megatron bf16 recipe).

    Every floating leaf — norm scales and biases included, as in the
    reference — is cast to the compute dtype once, under autograd, so the
    gradients flow back to the master copy in its own dtype.  The tree
    itself when the two dtypes coincide (the fp32 CPU tests)."""
    if policy.pdt == policy.cdt:
        return params

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(policy.cdt) if tree.is_floating_point() else tree

    return cast(params)


def policy_for(model_cfg) -> Policy:
    return Policy(param_dtype=model_cfg.param_dtype, compute_dtype=model_cfg.dtype)
