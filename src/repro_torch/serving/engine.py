"""Serving engine of the port: batched embedding extraction.

The reference engine also runs continuous-batching generation over a
dense or paged KV cache; that comes with the generation slice of the port
(ROADMAP).  This engine holds what ``embed`` needs — the slot count that
sizes every dispatch, ``max_len``, an injectable clock, the lifecycle
counters and the optional metrics registry and trace recorder — and
allocates no decode cache.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TraceRecorder


class Engine:
    def __init__(self, model: Model, *, slots: int, max_len: int,
                 clock: Callable[[], float] = time.time,
                 metrics: Optional[MetricsRegistry] = None,
                 trace: Optional[TraceRecorder] = None):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self._clock = clock
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "rejected": 0, "timeouts": 0,
            "errors": 0, "cancelled": 0, "preempted": 0, "resumed": 0,
        }
        self.metrics = metrics
        self.trace = trace
        self._mc = None
        if metrics is not None:
            fam = metrics.counter(
                "engine_requests_total",
                "request lifecycle transitions by event", labels=("event",),
            )
            self._mc = {k: fam.labels(k) for k in self.counters}

    # ---------------------------------------------------------- telemetry
    def _bump(self, name: str, n: int = 1) -> None:
        """Advance a lifecycle counter in both the ``counters`` dict and the
        metrics registry — one call site per transition, so the two views
        cannot drift."""
        self.counters[name] += n
        if self._mc is not None:
            self._mc[name].inc(n)

    def _emit(self, event: str, ts: Optional[float] = None, **data) -> None:
        """Record one engine-scoped trace event, stamped by the engine's clock."""
        if self.trace is None:
            return
        self.trace.emit(event, ts=self._clock() if ts is None else ts, **data)

    # ---------------------------------------------------------- embedding
    def embed(self, prompts: List[List[int]]) -> np.ndarray:
        """Batched embedding extraction: token prompts -> (n, d_model)
        float32 masked-mean-pooled vectors, in input order.

        Prompts group by power-of-2 length bucket (minimum 8, capped at
        ``max_len``, never below the prompt's length) and dispatch in rows
        of up to ``slots``, each padded to exactly ``slots`` rows.  Every
        dispatch stays on the device; the (n, d) result comes back in one
        device-to-host copy at the end.  Each prompt counts submitted and
        completed; each dispatch emits a ``prefill`` event and the call one
        ``finish``."""
        cfg = self.model.cfg
        prompts = [np.asarray(p, np.int32) for p in prompts]
        n = len(prompts)
        if n == 0:
            return np.zeros((0, cfg.d_model), np.float32)
        for i, p in enumerate(prompts):
            if p.ndim != 1 or len(p) == 0:
                raise ValueError(f"prompt {i}: empty or non-1-D")
            if len(p) > self.max_len:
                raise ValueError(
                    f"prompt {i}: {len(p)} tokens overflows max_len {self.max_len}"
                )
        self._bump("submitted", n)
        groups: Dict[int, List[int]] = {}
        for i, p in enumerate(prompts):
            b = 8
            while b < len(p):
                b *= 2
            groups.setdefault(max(len(p), min(b, self.max_len)), []).append(i)
        dev = self.model.device
        order, parts = [], []       # input positions, device (rows, d) slices
        t0 = self._clock()
        for L in sorted(groups):
            idxs = groups[L]
            for s in range(0, len(idxs), self.slots):
                chunk = idxs[s : s + self.slots]
                toks = np.zeros((self.slots, L), np.int32)
                lens = np.zeros((self.slots,), np.int32)
                for r, gi in enumerate(chunk):
                    toks[r, : len(prompts[gi])] = prompts[gi]
                    lens[r] = len(prompts[gi])
                self._emit("prefill", embed=True, bucket=L, rows=len(chunk))
                emb = self.model.embed_pool(torch.as_tensor(toks, device=dev),
                                            torch.as_tensor(lens, device=dev))
                order.extend(chunk)
                parts.append(emb[: len(chunk)])
        host = torch.cat(parts).cpu().numpy()       # one device->host copy
        out = np.zeros((n, host.shape[-1]), np.float32)
        out[np.asarray(order, np.int64)] = host
        self._bump("completed", n)
        self._emit("finish", embed=True, embedded=n, wall=self._clock() - t0)
        return out
