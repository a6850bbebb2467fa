"""``LLM`` — the serving facade of the port.

    model = build_model(get_config("esm2-650m"))          # on the GPU
    llm = LLM(model, slots=32, max_len=1024)
    vecs = llm.embed([tok.encode(seq) for seq in sequences])   # (n, 1280) fp32

Only embedding extraction is ported so far; ``generate`` and ``stream``
come with the generation slice (ROADMAP).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.config import ServeConfig
from repro_torch.serving.engine import Engine


class LLM:
    """Facade over the serving engine; construction mirrors ``Engine``."""

    def __init__(self, model, *, slots: int = 4, max_len: int = 512,
                 clock: Callable[[], float] = time.time,
                 metrics: Optional[Any] = None, trace: Optional[Any] = None):
        self.engine = Engine(model, slots=slots, max_len=max_len, clock=clock,
                             metrics=metrics, trace=trace)

    @classmethod
    def from_config(cls, model, sc: ServeConfig, **kw) -> "LLM":
        """Slots and max_len from a ``ServeConfig``."""
        return cls(model, slots=sc.batch_size, max_len=sc.max_seq_len, **kw)

    def embed(self, prompts) -> np.ndarray:
        """Batched embedding extraction: token prompts -> ``(n, d_model)``
        float32 masked-mean-pooled vectors, in input order.  See
        ``Engine.embed``."""
        return self.engine.embed(prompts)
