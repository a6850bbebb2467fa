"""Mixed-precision policy (BioNeMo/Megatron convention).

Parameters are stored in ``param_dtype`` (fp32 master by default), compute
runs in ``compute_dtype`` (bf16): every weight is cast to the compute dtype
where it enters a matmul, and the residual stream stays in it.  Norms,
RoPE, attention internals and pooling run in fp32.
"""
from __future__ import annotations

from dataclasses import dataclass

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


def policy_for(model_cfg) -> Policy:
    return Policy(param_dtype=model_cfg.param_dtype, compute_dtype=model_cfg.dtype)
