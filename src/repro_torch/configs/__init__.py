"""Model-zoo registry of the port: one module per architecture.

Registered: every decoder and encoder architecture of the reference's zoo
— the ESM-2 protein LMs (bidirectional dense stack, LayerNorm, GELU MLP,
RoPE) and Geneformer-106M (the same stack over gene tokens, with learned
positions in place of RoPE); the causal dense stacks Qwen2-7B, Qwen1.5-32B
and Llama-3-405B (RMSNorm, SwiGLU) and Command-R-35B (parallel attention +
FFN residual, bias-free LayerNorm); the Llama-4 MoE models Scout (an MoE
FFN on every layer) and Maverick (dense and MoE layers alternating); and
Mamba2-2.7B and Jamba-1.5-Large (SSD layers, Jamba's hybrid with attention
and MoE); the encoder-decoder models MolMIM-65M (SMILES seq2seq) and
Whisper-medium (an audio stub: precomputed frame embeddings), and
InternVL2-26B (a vision stub: patch embeddings projected in front of the
text).  ``get_config(name)`` returns the full config,
``get_smoke_config(name)`` the reduced same-family variant the CPU tests
use.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict

from repro_torch.core.config import ModelConfig, reduced

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}

_MODULES = ["esm2_650m", "esm2_3b", "geneformer_106m", "qwen2_7b", "qwen1p5_32b",
            "command_r_35b", "llama3_405b", "llama4_scout_17b_a16e",
            "llama4_maverick_400b_a17b", "mamba2_2p7b", "jamba_1p5_large_398b",
            "molmim_65m", "whisper_medium", "internvl2_26b"]


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
