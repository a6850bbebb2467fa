"""LR schedules: WSD (warmup-stable-decay), cosine, Noam, constant — the
port's copy of the reference's ``optim/schedule.py``, in fp32 on the step's
device (a device step tensor needs no host sync)."""
from __future__ import annotations

import math
from typing import Union

import torch

from repro_torch.core.config import TrainConfig


def lr_at(tc: TrainConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32, device=s.device)  # noqa: E731
    peak = tc.learning_rate
    warm = f32(max(tc.warmup_steps, 1))
    ramp = peak * s / warm
    if tc.schedule == "const":
        return torch.where(s < warm, ramp, peak)
    if tc.schedule == "noam":
        # Vaswani et al.: d^-0.5 * min(s^-0.5, s * warm^-1.5), scaled by peak
        s1 = torch.clamp(s, min=1.0)
        return peak * torch.minimum(s1 ** -0.5, s1 * warm ** -1.5) / (warm ** -0.5)
    total = f32(max(tc.total_steps, 1))
    if tc.schedule == "cosine":
        frac = torch.clamp((s - warm) / torch.clamp(total - warm, min=1.0), 0.0, 1.0)
        cos = tc.min_lr + 0.5 * (peak - tc.min_lr) * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warm, ramp, cos)
    # WSD: warmup -> stable -> linear decay over the last decay_steps
    decay = f32(max(tc.decay_steps, 1))
    decay_start = total - decay
    lin = peak + (tc.min_lr - peak) * torch.clamp((s - decay_start) / decay, 0.0, 1.0)
    stable = torch.where(s < decay_start, peak, lin)
    return torch.where(s < warm, ramp, stable)
