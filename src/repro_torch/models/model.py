"""Top-level model: the param tree as an ``nn.Module`` plus the forward
entry points ported so far (embedding extraction).

``build_model(cfg)`` materializes seeded random weights on the GPU; pass
``device="cpu"`` to run on the CPU (the tests do).  Weights from the
reference package cross in through ``checkpoint/bridge.py``:
``Model(cfg, from_jax_params(tree))``.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch
from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import ParamTree, materialize
from repro_torch.core.precision import policy_for
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's param tree for the stacks the port runs."""
    return {
        "embed": L.embedding_defs(cfg),
        "layers": T.stack_defs(cfg),
        "final_norm": L.norm_defs(cfg, cfg.d_model),
        "head": L.lm_head_defs(cfg),
    }


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        T.check_supported(cfg)
        self.cfg = cfg
        self.policy = policy_for(cfg)
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params.embed.tok.device

    # ------------------------------------------------------------ backbone
    def _decoder_input(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed_apply(self.cfg, self.params.tree()["embed"], tokens,
                             compute_dtype=self.policy.cdt)

    def _backbone(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward in train mode, then the final norm."""
        p = self.params.tree()
        x, _ = T.decoder_stack(self.cfg, p["layers"], x, mode="train")
        return L.norm_apply(self.cfg, p["final_norm"], x)

    # ------------------------------------------------------------ serving
    @torch.inference_mode()
    def embed_pool(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Masked mean-pooled sequence embeddings: (B, S) tokens + (B,)
        valid lengths -> (B, d_model) float32.

        Runs the full-sequence forward in train mode.  For bidirectional
        (MLM) models the pad tokens are visible to attention exactly as in
        training — no key-padding mask — and only positions < lengths[b]
        enter the fp32 mean, as in the reference."""
        x = self._backbone(self._decoder_input(tokens))
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths.to(x.device)[:, None]
        x = x.float() * mask[..., None]
        denom = mask.sum(dim=1).clamp_min(1).float()
        return x.sum(dim=1) / denom[:, None]


def _resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The GPU unless the caller names another device; no silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def build_model(cfg: ModelConfig, *, device: Union[None, str, torch.device] = None,
                seed: int = 0) -> Model:
    """A model with seeded random weights on ``device`` (default: cuda)."""
    dev = _resolve_device(device)
    return Model(cfg, materialize(param_defs(cfg), seed, policy_for(cfg).pdt, dev))
