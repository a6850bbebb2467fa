"""Profiling hooks: a trace of a run, a named profiler scope and a host
step timer.

The port's copy of the reference's ``repro.obs.profile``, all default-off
and free when off:

  * :func:`trace_ctx` — a context manager around ``torch.profiler``: the
    run inside it lands in a trace file (Chrome / TensorBoard format,
    ``*.pt.trace.json``) under the given directory, the card's kernels
    included when there is one.  A falsy directory, or a profiler that is
    already running, makes it a no-op, so launchers pass the flag through
    unconditionally.
  * :class:`annotate` — a named ``torch.profiler.record_function`` scope
    marking a host-side region (the engine's decode dispatch, a prefill),
    so it is attributable in a ``torch.profiler`` trace.  Constructed with
    ``enabled=False`` it does nothing; the engine gates it on its
    ``profile`` knob.
  * :class:`StepTimer` — a host-side per-phase timing accumulator
    (``perf_counter`` spans, plain floats).  It never synchronizes the
    device: it measures dispatch wall time, which is what the host-side
    scheduling loop stalls on, and a sync would break the engine's one
    host transfer per decode step.  A span costs two clock reads and a
    dict update.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace_ctx(log_dir: Optional[str]) -> Iterator[None]:
    """``with trace_ctx(dir):`` profiles the enclosed run into ``dir``."""
    if not log_dir or getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class annotate:
    """Named profiler scope; does nothing unless ``enabled``.

    ``with annotate("engine/decode", enabled=profile): ...`` shows up as a
    named span on the host timeline of a ``torch.profiler`` capture."""

    __slots__ = ("_ctx",)

    def __init__(self, name: str, enabled: bool = True) -> None:
        self._ctx = torch.profiler.record_function(name) if enabled else None

    def __enter__(self) -> "annotate":
        if self._ctx is not None:
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
        return False


class StepTimer:
    """Accumulates wall time per named phase across many steps.

    ``totals[name] = [count, total_seconds]``; ``summary()`` renders
    mean/total per phase.  Host-side only: it never synchronizes the
    device."""

    __slots__ = ("totals", "_clock")

    def __init__(self, clock=time.perf_counter) -> None:
        self.totals: Dict[str, list] = {}
        self._clock = clock

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            cell = self.totals.get(name)
            if cell is None:
                self.totals[name] = [1, dt]
            else:
                cell[0] += 1
                cell[1] += dt

    def mean(self, name: str) -> float:
        cell = self.totals.get(name)
        return cell[1] / cell[0] if cell else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"count": c, "total_s": t, "mean_s": t / c}
            for name, (c, t) in sorted(self.totals.items())
        }

    def report(self) -> str:
        return "\n".join(
            f"{name}: n={v['count']} mean={v['mean_s'] * 1e3:.3f}ms "
            f"total={v['total_s']:.3f}s"
            for name, v in self.summary().items()
        )
