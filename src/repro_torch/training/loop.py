"""Training engine (the port's copy of the reference's ``training/loop.py``).

``Trainer`` owns the training vertical:

* the step — ``make_train_step``, run eagerly (PyTorch has no AOT compile
  to cache);
* device prefetch — the next batches are copied to the device while the
  current step runs: pinned host buffers, copied on a side CUDA stream
  that the compute stream waits on only when it takes the batch;
* device-side metrics — each step's metrics stay on the device as 0-dim
  tensors; ONE device-to-host copy per log interval fetches them all;
* the non-finite guard — skipped steps are counted at each flush, and
  ``NonFiniteLossError`` is raised after ``tc.max_nonfinite_skips``
  consecutive ones;
* reporting — tokens/s, step time and, given ``peak_flops``, MFU from the
  model-FLOPs convention 6 · active params · processed tokens; with
  ``metrics=MetricsRegistry()`` the flush also feeds the shared ``obs``
  registry from the values it already fetched;
* checkpoints — the full TrainState (params + AdamW moments + step) plus
  the data cursor and counters; ``run(resume_from=…)`` continues the
  interrupted run exactly;
* profiling — ``profile=True`` wraps each step's dispatch in the
  ``train/step`` profiler range and times it on the host into
  ``Trainer.step_timer`` (span ``train_step``).

Batches may change their (B, L) from step to step (size-aware batching):
the prefetch, the MFU count and the checkpointed cursor follow each
batch's own shape.  The reference compiles its step once a shape; the
port runs eagerly and caches nothing per shape.  A pipeline with
``close()`` (``BackgroundProducer``) is closed by its caller.

The trainer trains the model in place: its TrainState's params are the
model's own parameters (``init_train_state``).

On a mesh (the model's, ``build_model(cfg, pc, mesh)``) every rank draws
the same global batch from the same pipeline and keeps its rows of the
batch axes (``ShardingCtx.batch_rows``, micro-batch by micro-batch); the
metrics are already global (``Model.loss_fn``, ``adamw.global_norm``), so
one host transfer a log interval still fetches them.  Only the mesh's
first rank prints; every rank takes part in a checkpoint's gathers and the
first one writes it, in the one-device format.  ``tokens_per_sec`` and the
FLOP count cover the global batch.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.config import ParallelConfig, TrainConfig
from repro_torch.core.module import tree_leaves
from repro_torch.models.model import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import StepTimer, annotate
from repro_torch.training import train_step as TS
from repro_torch.training.train_step import TrainState


class NonFiniteLossError(RuntimeError):
    """Raised after ``TrainConfig.max_nonfinite_skips`` consecutive
    optimizer steps were skipped for a non-finite loss or grad norm.
    Carries ``step`` (the last offending optimizer step) and ``skips``."""

    def __init__(self, step: int, skips: int):
        super().__init__(
            f"non-finite loss/grad-norm on {skips} consecutive steps "
            f"(last: optimizer step {step}); update was skipped each time "
            f"— aborting instead of training on garbage"
        )
        self.step = step
        self.skips = skips


class _DevicePrefetch:
    """Keeps ``DEPTH`` batches in flight to the device: the next batch copies
    while the current step runs.

    Each buffered batch carries the pipeline's post-draw cursor, so a
    checkpoint taken after consuming batch N records "next draw is N+1"
    although the prefetcher has already pulled later batches."""

    DEPTH = 2

    def __init__(self, pipeline, device: torch.device, select=None):
        self.pipeline = pipeline
        self.select = select        # a host batch leaf -> the rows this rank keeps
        self.src = iter(pipeline)
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.buf: collections.deque = collections.deque()
        self.cursor = self._snapshot()  # state before any draw
        self.exhausted = False

    def _snapshot(self):
        sd = getattr(self.pipeline, "state_dict", None)
        return sd() if callable(sd) else None

    def _place(self, batch: Dict[str, np.ndarray]):
        if self.select is not None:
            batch = {k: self.select(v) for k, v in batch.items()}
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self.stream is None:
            return {k: v.to(self.device) for k, v in host.items()}, None
        with torch.cuda.stream(self.stream):
            dev = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return dev, done

    def _pull(self) -> None:
        try:
            b = next(self.src)
        except StopIteration:
            self.exhausted = True
            return
        self.buf.append((*self._place(b), self._snapshot()))

    def __next__(self):
        while len(self.buf) < self.DEPTH and not self.exhausted:
            self._pull()
        if not self.buf:
            raise StopIteration
        batch, done, cur = self.buf.popleft()
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
            for v in batch.values():   # the compute stream now owns the memory
                v.record_stream(torch.cuda.current_stream(self.device))
        if cur is not None:
            self.cursor = cur
        return batch


class Trainer:
    """Drive it with ``run(batches)`` for a whole schedule, or
    ``prepare(batches)`` + repeated ``step()`` for finer control.  ``pc``
    defaults to the model's ``ParallelConfig``, whose ``remat_policy`` the
    stack reads; a ``pc`` with another policy is refused."""

    def __init__(
        self,
        model: Model,
        tc: TrainConfig,
        *,
        pc: Optional[ParallelConfig] = None,
        hooks: Optional[List[Callable[[int, Dict[str, float]], None]]] = None,
        verbose: bool = True,
        peak_flops: Optional[float] = None,
        metrics: Optional[MetricsRegistry] = None,
        profile: bool = False,
    ):
        if pc is not None and pc.remat_policy != model.pc.remat_policy:
            raise ValueError(
                f"pc.remat_policy {pc.remat_policy!r} differs from the model's "
                f"{model.pc.remat_policy!r}: the stack reads the model's; build it with this "
                "ParallelConfig (build_model(cfg, pc))")
        self.model, self.tc, self.pc = model, tc, pc or model.pc
        self.ctx = model.ctx
        self.hooks = list(hooks or [])
        self.verbose = verbose and self.ctx.is_first
        self.peak_flops = peak_flops
        self._step_fn = TS.make_train_step(model, tc)
        self.state: Optional[TrainState] = None
        self.step_idx = 0            # optimizer steps completed
        self.history: List[Dict[str, float]] = []
        self._pending: List[Dict[str, torch.Tensor]] = []   # device metrics since last log
        self._pending_flops = 0.0
        self._tokens_seen = 0.0
        self.skipped_total = 0
        self._skip_streak = 0
        self._it: Optional[_DevicePrefetch] = None
        self._t0 = self._t_log = 0.0
        self.metrics = metrics
        self.step_timer = StepTimer() if profile else None
        if metrics is not None:
            self._c_steps = metrics.counter("train_steps_total", "optimizer steps completed")
            self._c_tokens = metrics.counter("train_tokens_total", "non-pad tokens consumed")
            self._c_skipped = metrics.counter(
                "train_skipped_steps_total", "updates withheld for non-finite loss/grads")
            self._h_step = metrics.histogram(
                "train_step_time_seconds", "mean step wall per log interval")
            self._tg = {
                name: metrics.gauge(f"train_{name}", help)
                for name, help in (
                    ("loss", "last flushed total loss"),
                    ("grad_norm", "last flushed global gradient norm"),
                    ("tokens_per_sec", "interval throughput"),
                    ("lr", "current learning rate"),
                    ("mfu", "model FLOPs utilization of the interval"),
                    ("aux_loss", "router load-balance loss (MoE)"),
                    ("router_entropy", "mean router entropy (MoE)"),
                    ("router_drop_frac", "capacity-dropped slot fraction"),
                )
            }
            self._g_load = metrics.gauge("train_router_load",
                                         "per-expert fraction of kept routed slots",
                                         labels=("expert",))

    # ------------------------------------------------------------ lifecycle
    def prepare(self, batches, *, state: Optional[TrainState] = None,
                resume_from: Optional[str] = None) -> "Trainer":
        if resume_from:
            self.load(resume_from, batches)
        elif state is not None:
            self.state = state
        if self.state is None:
            self.state = TS.init_train_state(self.model, self.pc)
        select = None
        if self.model.sharded:
            accum = max(int(self.tc.accum_steps), 1)
            select = lambda v: self.ctx.batch_rows(v, accum)  # noqa: E731
        self._it = _DevicePrefetch(batches, self.model.device, select)
        self._t0 = self._t_log = time.perf_counter()
        return self

    # ------------------------------------------------------------ stepping
    def step(self) -> int:
        """One optimizer step on the next prefetched batch; logs and
        checkpoints on schedule."""
        batch = next(self._it)
        timed = self.step_timer is not None
        with (self.step_timer.span("train_step") if timed else contextlib.nullcontext()), \
                annotate("train/step", enabled=timed):
            self.state, metrics = self._step_fn(self.state, batch)
        toks = batch["tokens"]
        self._pending_flops += (6.0 * self.model.cfg.active_param_count() * toks.numel()
                                * self.ctx.data_ranks)
        s = self.step_idx
        self.step_idx = s + 1
        self._pending.append(metrics)
        if (s % max(self.tc.log_every, 1)) == 0 or s == self.tc.total_steps - 1:
            self._flush_log(s)
        if self.tc.ckpt_every and self.tc.ckpt_dir and self.step_idx % self.tc.ckpt_every == 0:
            self.save(os.path.join(self.tc.ckpt_dir, f"step_{self.step_idx}"))
        return self.step_idx

    def _fetch(self) -> List[Dict[str, object]]:
        """The pending device metrics on the host — scalars as floats, the
        per-expert router load as a list — in ONE device-to-host copy."""
        first = self._pending[0]
        keys = list(first)
        flat = torch.stack([torch.cat([m[k].float().reshape(-1) for k in keys])
                            for m in self._pending]).cpu().tolist()
        out = []
        for row in flat:
            vals, i = {}, 0
            for k in keys:
                n = first[k].numel()
                vals[k] = row[i] if first[k].dim() == 0 else row[i:i + n]
                i += n
            out.append(vals)
        return out

    def _flush_log(self, s: int) -> None:
        fetched = self._fetch()
        self._pending = []
        now = time.perf_counter()
        dt = now - self._t_log
        self._t_log = now
        n = len(fetched)
        tokens = float(sum(m["tokens"] for m in fetched))
        self._tokens_seen += tokens
        for i, fm in enumerate(fetched):
            if fm["skipped"] > 0.0:
                self.skipped_total += 1
                self._skip_streak += 1
                if self.metrics is not None:
                    self._c_skipped.inc()
                if self._skip_streak >= max(self.tc.max_nonfinite_skips, 1):
                    raise NonFiniteLossError(s - n + 1 + i, self._skip_streak)
            else:
                self._skip_streak = 0
        # vector-valued metrics (the per-expert router load) stay out of the
        # scalar history and feed the labeled gauge instead
        last = fetched[-1]
        m = {k: v for k, v in last.items() if not isinstance(v, list)}
        step_time = dt / max(n, 1)
        m.update(step=s, wall=now - self._t0, step_time=step_time,
                 tokens_per_sec=tokens / dt if dt > 0 else 0.0,
                 tokens_seen=self._tokens_seen, skipped_total=self.skipped_total)
        flops, self._pending_flops = self._pending_flops, 0.0
        m["model_flops_per_sec"] = flops / dt if dt > 0 else 0.0
        if self.peak_flops:
            m["mfu"] = m["model_flops_per_sec"] / self.peak_flops
        if self.metrics is not None:
            self._c_steps.inc(n)
            self._c_tokens.inc(tokens)
            self._h_step.observe(step_time)
            for name, gauge in self._tg.items():
                if name in m:
                    gauge.set(m[name])
            for e, frac in enumerate(last.get("router_load", [])):
                self._g_load.labels(str(e)).set(frac)
        self.history.append(m)
        if self.verbose:
            skips = f"  SKIPPED {self.skipped_total}" if self.skipped_total else ""
            print(f"step {s:5d}  loss {m['loss']:.4f}  ce {m['ce_loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}  "
                  f"{m['tokens_per_sec']:.0f} tok/s  {m['wall']:.1f}s{skips}")
        for h in self.hooks:
            h(s, m)

    def run(self, batches, *, state: Optional[TrainState] = None,
            resume_from: Optional[str] = None):
        """Train to ``tc.total_steps``; returns ``(state, history)``."""
        self.prepare(batches, state=state, resume_from=resume_from)
        while self.step_idx < self.tc.total_steps:
            self.step()
        if self.tc.ckpt_every and self.tc.ckpt_dir:
            final = os.path.join(self.tc.ckpt_dir, f"step_{self.tc.total_steps}")
            if not os.path.isdir(final):
                self.save(final)
        return self.state, self.history

    # -------------------------------------------------------- checkpointing
    def save(self, ckpt_dir: str) -> None:
        """Full-state checkpoint: TrainState + data cursor + counters
        (``tokens_seen`` includes the steps still pending a log flush)."""
        pending = float(torch.stack([m["tokens"] for m in self._pending]).sum().cpu()) \
            if self._pending else 0.0
        extra = {
            "step_idx": self.step_idx,
            "tokens_seen": self._tokens_seen + pending,
            "data": self._it.cursor if self._it is not None else None,
        }
        if not self.model.sharded:
            ckpt.save_train_state(ckpt_dir, self.state, self.step_idx, extra=extra)
            return
        m = self.model

        def gather(path, x):
            return self.ctx.gather_whole(x, m.spec_at(path).store)

        ckpt.save_train_state(ckpt_dir, self.state, self.step_idx, extra=extra, gather=gather,
                              write=self.ctx.is_first)
        self.ctx.barrier()

    def load(self, ckpt_dir: str, batches=None) -> "Trainer":
        """Restore the full TrainState into the model's parameters (this
        rank's shards on a mesh) and rewind the data pipeline to the saved
        cursor."""
        m = self.model
        params = m.params.tree()
        keep = ((lambda path, x: self.ctx.shard(x, m.spec_at(path).store)) if m.sharded
                else None)
        state, step, extra = ckpt.restore_train_state(ckpt_dir, params, m.device, keep=keep)
        with torch.no_grad():
            for p, r in zip(tree_leaves(params), tree_leaves(state.params)):
                p.copy_(r)
        self.state = TrainState(params, state.opt)
        self.step_idx = int(extra.get("step_idx", step))
        self._tokens_seen = float(extra.get("tokens_seen", 0.0))
        cur = extra.get("data")
        if cur is not None and hasattr(batches, "load_state_dict"):
            batches.load_state_dict(cur)
        return self


def run_training(model: Model, tc: TrainConfig, batches: Iterator[Dict[str, np.ndarray]], *,
                 state: Optional[TrainState] = None, pc: Optional[ParallelConfig] = None,
                 hooks: Optional[List[Callable[[int, Dict[str, float]], None]]] = None,
                 verbose: bool = True):
    """Functional wrapper over :class:`Trainer`; returns ``(state, history)``.
    ``pc`` (default: the model's) sets the optimizer state's dtype
    (``optimizer_state_dtype``)."""
    return Trainer(model, tc, pc=pc, hooks=hooks, verbose=verbose).run(batches, state=state)
