"""Model-zoo registry of the port: one module per architecture.

Registered so far: the architectures the port's kernels and layers cover —
the ESM-2 protein LMs (bidirectional dense stack, LayerNorm, GELU MLP) and
Qwen2-7B (causal GQA stack, RMSNorm, SwiGLU MLP), all with RoPE.  ``get_config(name)`` returns the full config,
``get_smoke_config(name)`` the reduced same-family variant the CPU tests
use.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict

from repro_torch.core.config import ModelConfig, reduced

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}

_MODULES = ["esm2_650m", "esm2_3b", "qwen2_7b"]


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    _REGISTRY[fn().name] = fn
    return fn


def _load_all() -> None:
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))
