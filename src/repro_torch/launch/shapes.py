"""The assigned input shapes and ``meta`` stand-ins for every training input
(the port's copy of part of the reference's ``launch/shapes.py``).

``train_batch_specs`` gives a training batch's tensors on the ``meta``
device (shapes and dtypes, no memory) and ``batch_shardings`` each input
dim's mesh axes.  The reference's ``dryrun_bundle`` lowers its entry points
through XLA for a compile-only sweep; it has no PyTorch counterpart and is
not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.config import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
    # the paper's own pretraining workloads (BioNeMo recipes)
    "mlm_1k": InputShape("mlm_1k", 1024, 2048, "train"),      # ESM-2 recipe
    "mlm_2k": InputShape("mlm_2k", 2048, 1024, "train"),      # Geneformer
}

# archs that run long_500k (sub-quadratic decode memory and compute)
LONG_OK_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name != "long_500k":
        return True, ""
    if cfg.family in LONG_OK_FAMILIES:
        return True, "ssm/hybrid state decode"
    if cfg.sliding_window:
        return True, f"sliding-window {cfg.sliding_window} decode cache"
    return False, ("pure full-attention arch: a 500k-token decode cache is in the quadratic "
                   "regime; skipped")


def _i32(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _f(shape, dt=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dt, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """A global training batch of ``shape`` as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if cfg.frontend == "vision_stub":
        batch["tokens"] = _i32((B, S - cfg.num_frontend_tokens))
        batch["img_embeds"] = _f((B, cfg.num_frontend_tokens, cfg.d_model))
    elif cfg.frontend == "audio_stub":
        batch["tokens"] = _i32((B, S))
        batch["enc_embeds"] = _f((B, cfg.num_frontend_tokens, cfg.d_model))
    elif cfg.is_encoder_decoder:
        batch["tokens"] = _i32((B, S))
        batch["src_tokens"] = _i32((B, S))
    elif cfg.objective == "mlm":
        batch["tokens"] = _i32((B, S))
        batch["targets"] = _i32((B, S))
        batch["loss_mask"] = _f((B, S), torch.float32)
    else:
        batch["tokens"] = _i32((B, S))
    return batch


def batch_shardings(cfg: ModelConfig, shape: InputShape, rules: Dict[str, Any]
                    ) -> Dict[str, Tuple[Any, ...]]:
    """Each input's spec: the leading (row) dim over the batch axes, the
    rest replicated (a rank keeps its rows: ``ShardingCtx.batch_rows``)."""
    b_ax = rules.get("batch")
    return {k: (b_ax, *([None] * (v.dim() - 1))) if v.dim() else ()
            for k, v in train_batch_specs(cfg, shape).items()}
