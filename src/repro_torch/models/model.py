"""Top-level model: the param tree as an ``nn.Module`` plus the entry points
ported so far — embedding extraction and the training loss.

``build_model(cfg)`` materializes seeded random weights on the GPU; pass
``device="cpu"`` to run on the CPU (the tests do).  Weights from the
reference package cross in through ``checkpoint/bridge.py``:
``Model(cfg, from_jax_params(tree))``.  ``loss_fn(params, batch)`` takes the
param tree explicitly, as the reference's does, so the train step can run
it on the compute-dtype view of its master copy.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import ParamTree, materialize
from repro_torch.core.precision import policy_for
from repro_torch.kernels import ops
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
    def _decoder_input(self, params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        return L.embed_apply(self.cfg, params["embed"], tokens, compute_dtype=self.policy.cdt)

    def _backbone(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward in train mode, then the final norm."""
        x, _ = T.decoder_stack(self.cfg, params["layers"], x, mode="train")
        return L.norm_apply(self.cfg, params["final_norm"], x)

    def head_weight(self, params: Dict[str, Any]) -> torch.Tensor:
        return L.lm_head_weight(self.cfg, params["head"], params["embed"])

    def logits(self, params: Dict[str, Any], hidden: torch.Tensor) -> torch.Tensor:
        """(…, d_model) -> (…, Vpad) logits in hidden's dtype: the optional
        softcap, and −1e30 on the Megatron vocab padding."""
        cfg = self.cfg
        lg = hidden @ self.head_weight(params).to(hidden.dtype)
        if cfg.logit_softcap > 0:
            lg = cfg.logit_softcap * torch.tanh(lg / cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            pad_mask = torch.arange(cfg.padded_vocab, device=lg.device) < cfg.vocab_size
            lg = torch.where(pad_mask, lg, torch.tensor(-1e30, dtype=lg.dtype, device=lg.device))
        return lg

    # ------------------------------------------------------------ training
    def loss_fn(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Masked-mean cross-entropy of a batch -> (loss, metrics).

        ``mlm``: every position predicts ``targets``, weighted by
        ``loss_mask``.  ``clm``: position t predicts token t+1, weighted by
        ``loss_mask[:, 1:]`` when given.  The loss is computed for every
        token by the fused cross-entropy op (the (tokens × vocab) logits
        never materialize on the kernel path) and then weighted, as in the
        reference; ``metrics`` holds ``ce_loss``, ``aux_loss`` (0 for the
        dense stack) and ``tokens`` (the mask's sum, at least 1)."""
        cfg = self.cfg
        x = self._backbone(params, self._decoder_input(params, batch["tokens"]))
        B, S, D = x.shape
        if cfg.objective == "mlm":
            hidden = x.reshape(B * S, D)
            targets = batch["targets"].reshape(-1)
            mask = batch["loss_mask"].reshape(-1).float()
        else:  # clm: next-token over the sequence
            hidden = x[:, :-1, :].reshape(-1, D)
            targets = batch["tokens"][:, 1:].reshape(-1)
            mask = batch.get("loss_mask")
            mask = (mask[:, 1:].reshape(-1).float() if mask is not None
                    else torch.ones(targets.shape, dtype=torch.float32, device=x.device))
        w_head = self.head_weight(params).to(self.policy.cdt)
        losses, _ = ops.cross_entropy(hidden, w_head, targets, vocab=cfg.vocab_size,
                                      impl=cfg.kernel_impl)
        denom = mask.sum().clamp_min(1.0)
        loss = (losses * mask).sum() / denom
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return loss, {"ce_loss": loss, "aux_loss": aux, "tokens": denom}

    # ------------------------------------------------------------ serving
    @torch.inference_mode()
    def embed_pool(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Masked mean-pooled sequence embeddings: (B, S) tokens + (B,)
        valid lengths -> (B, d_model) float32.

        Runs the full-sequence forward in train mode.  For bidirectional
        (MLM) models the pad tokens are visible to attention exactly as in
        training — no key-padding mask — and only positions < lengths[b]
        enter the fp32 mean, as in the reference."""
        p = self.params.tree()
        x = self._backbone(p, self._decoder_input(p, tokens))
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths.to(x.device)[:, None]
        x = x.float() * mask[..., None]
        denom = mask.sum(dim=1).clamp_min(1).float()
        return x.sum(dim=1) / denom[:, None]


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
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
    dev = resolve_device(device)
    return Model(cfg, materialize(param_defs(cfg), seed, policy_for(cfg).pdt, dev))
