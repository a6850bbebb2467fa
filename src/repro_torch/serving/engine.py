"""Serving engine of the port: continuous-batching generation over a dense
or a paged KV cache, and batched embedding extraction.

The port's copy of the reference's ``repro.serving.engine``:

  * a fixed pool of B slots shares one preallocated KV cache
    (``Model.init_cache`` with a (B,) position vector), allocated at the
    first ``submit`` — an embed-only engine pays nothing for it;
  * an admitted request is prefilled alone (batch 1, right-padded to a
    power-of-2 bucket when the model is causal and has no SSM layer; an
    SSM or hybrid model prefills at the prompt's exact length) and its
    cache — K/V, or an SSM layer's conv buffer and state — is copied into
    its slot; its first token is sampled on the device;
  * every ``step`` decodes ALL slots in lockstep with per-slot positions;
    finished slots (stop / length) are released and refilled from the
    queue at the next step.

Two cache layouts:

``cache_layout="dense"``
    One (B, max_len) K/V buffer per layer; the decode write is an indexed
    write of B rows.

``cache_layout="paged"``
    Fixed-size pages of a pool shared by the slots, mapped per slot by a
    block table (``paged_cache.PageAllocator``, host-side).  Admission
    reserves the request's whole budget (prompt + max_new): a request that
    does not fit waits in the queue, one that can never fit is rejected at
    submit.  The decode write and attention go through the table
    (``kernels/paged_attention.py``); the device copy of the table moves
    only at admission, chunk completion, release and preemption.  With it:

    * ``prefix_cache=True`` — admission hashes the prompt's full blocks
      against the allocator's content-addressed page index; hash-hit
      blocks are shared (refcounted) and prefill runs over the suffix
      only; a fully cached prompt recomputes its last token in a private
      copy of its last page (copy-on-write).  A finished prompt's full
      blocks are registered for later requests.
    * ``prefill_chunk=N`` — prompts prefill in chunks of at most N tokens,
      one chunk per engine step while decodes are in flight, so a long
      prompt delays each decode step by at most one chunk.  Mid-prefill
      slots are invisible to the lockstep decode: their table rows are
      masked to the null page in the device copy.
    * ``preempt=True`` — when the queue head is blocked on pages, the
      newest in-flight decode is evicted and re-queued behind it; on
      re-admission it replays prompt + generated tokens, and its
      generation index keys the same sampling noise, so it resumes token
      for token.

    Prefix caching and chunked prefill need a causal attention-only
    decoder with no encoder and no frontend rows (prompt bucketing needs
    the first half of that); they are rejected otherwise.  A model with SSM
    layers serves over the dense layout only.

Frontends and encoders (``extra_batch``): one batch of extra inputs that
every admission's prefill takes beside its tokens, as in the reference —
``enc_embeds`` (1, T_enc, d_model) for Whisper, ``img_embeds`` (1, n_front,
d_model) for InternVL2 — so every request of an engine shares one audio or
image, and each admission runs the encoder again.  An encoder-decoder
engine holds a dense per-slot cross cache of ``num_frontend_tokens`` rows
in either layout, which each admission's prefill fills.  A vision model's
image rows sit in front of each prompt and count toward its budget; served
without ``img_embeds``, it has none.  An encoder-decoder whose cross length
is 0 (MolMIM: its encoder length is its source's) is refused: serve it
with ``repro_torch.launch.serve.generate``, the static batch over
``Model.prefill`` and ``Model.decode_step``.

Token-in/token-out: selection runs on the device (``ops.sample_tokens``:
the fused per-slot sampler, greedy rows degrade to argmax), the sampled
tokens feed the next step without visiting the host, and the only host
traffic of a steady step is ONE copy of the sampled (tokens, logprobs,
fault flags) triple, through :func:`to_host`.  The step has no ``.item()``,
no branch on a tensor, no boolean-mask indexing and no ``nonzero``.

Fault tolerance, as in the reference: a bounded queue (``max_queue``,
typed retriable :class:`EngineOverloaded`), per-request deadlines on an
injectable ``clock`` (queued requests time out without running, in-flight
ones at the next step boundary with their tokens so far), and a
non-finite sentinel that quarantines only the offending slot
(``finish_reason="error"``), with NaN injection through
``faults=FaultPlan(...)``.  ``health()`` snapshots the queue, the slots,
the watchdog and the lifecycle counters.

Sharded serving (tensor-parallel inference on a mesh): a model built on a
(data, model) mesh (``build_model(cfg, pc, mesh)``, ``launch/serve.py
--mesh DxM`` under torchrun) makes the engine mesh-aware with no API
change.  Every rank runs this same host loop on the same requests (one
SPMD engine).  The engine serves from ``Model.serving_params()``: each
weight whole over ``data``, the rank's heads and MLP columns over
``model``.  The dense K/V buffers and the paged pools hold the rank's K/V
heads (``parallel.sharding.rank_kv_heads``); the page allocator,
refcounts, prefix-hash index and LRU stay global host state, so a page id
means the same on every rank and prefix sharing and copy-on-write do not
depend on the mesh.  The block table, ``pos`` and every per-slot control
tensor are whole on every rank.  Each layer all-reduces twice over
``model`` (after ``wo`` and after ``w_out``); every kernel sees the rank's
heads as plain local tensors.  The logits are whole on every rank, so the
sampler reads the same row everywhere and a request's tokens depend only
on its seed and generation index, not on the mesh's shape.  The data
ranks are replicas: the same requests, the same tokens (splitting the
slots over ``data`` is ROADMAP item 14d).  Every rank must take the same
host decisions, or the collectives stop matching: the one input that can
differ between ranks is the clock, so the deadline decisions read rank
0's reading, agreed once a step (and at each submit) by a broadcast over
the mesh's Gloo host group (``ShardingCtx.agree``): no device transfer,
and still one ``to_host`` a decode step.  Telemetry timestamps read the
rank's own clock (only rank 0 writes them out in the launcher).

Telemetry: ``metrics=MetricsRegistry()`` makes the lifecycle counters,
gauges and TTFT / ITL / queue-wait / end-to-end histograms registry-backed;
``trace=TraceRecorder()`` records one event per lifecycle transition,
stamped by the engine's clock.  Both are host-side appends.
``profile=True`` wraps the decode dispatch and the prefills in named
``torch.profiler`` scopes and accumulates the ``decode`` and ``host_sync``
spans of each step in ``Engine.step_timer`` (host clock, no device sync).
``on_step(engine)``, called at the end of every step, is the launchers'
hook for periodic health and metrics output.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.obs.metrics import LATENCY_BUCKETS, MetricsRegistry
from repro_torch.obs.profile import StepTimer, annotate
from repro_torch.obs.trace import TraceRecorder
from repro_torch.serving.paged_cache import (
    NULL_PAGE,
    PageAllocator,
    copy_pages,
    pages_for,
    write_slot_paged,
)
from repro_torch.serving.sampling import SamplingParams, StopChecker, effective_params


class EngineOverloaded(RuntimeError):
    """Typed admission rejection: the bounded queue is full.

    Raised by :meth:`Engine.submit` when ``max_queue`` is reached.  It is
    retriable: the request was not mutated or partially admitted, and the
    caller may resubmit once :meth:`Engine.health` shows the queue
    draining."""

    retriable = True

    def __init__(self, uid: int, depth: int, max_queue: int):
        super().__init__(
            f"request {uid}: admission queue full ({depth}/{max_queue}); "
            f"retry after the queue drains"
        )
        self.queue_depth = depth
        self.max_queue = max_queue


@dataclasses.dataclass
class EngineHealth:
    """One snapshot of engine liveness (``Engine.health()``).

    ``steps_since_progress`` is the watchdog: engine steps since any
    request was admitted, advanced a prefill chunk, emitted a token, or
    finished."""

    queue_depth: int
    slots: int
    active_slots: int
    prefilling: int
    free_pages: Optional[int]       # None for the dense layout
    total_pages: Optional[int]
    steps: int
    steps_since_progress: int
    counters: Dict[str, int]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 32
    eos_id: int = -1             # -1: never stops early
    # sampling intent; None = greedy decode with max_new/eos_id.  When set,
    # a non-None params.max_new takes precedence (normalized at submit) and
    # eos_id >= 0 folds into the stop-token set
    params: Optional[SamplingParams] = None
    # wall-clock SLO from submit, in ms (params.deadline_ms wins when set)
    deadline_ms: Optional[float] = None
    # filled by the engine:
    output: Optional[List[int]] = None
    logprobs: Optional[List[float]] = None   # per-token, if params.logprobs
    # "stop" | "length" | "timeout" | "error" | "cancelled" once done
    finish_reason: str = ""
    preempted: int = 0           # times evicted and re-queued
    t_submit: float = 0.0
    t_admit: float = 0.0         # first admission to a slot (0 = never ran)
    t_first: float = 0.0
    t_done: float = 0.0
    _seq: int = -1               # submit order (engine-assigned)


@dataclasses.dataclass
class _Prefill:
    """A slot mid-way through an incremental (chunked or suffix) prefill."""

    req: Request
    prompt: np.ndarray           # the prompt (+ the generated tokens of a
                                 # resumed request), unpadded
    done: int                    # tokens whose K/V is already in the pages


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copy int32, float32 and bool tensors to the host in ONE transfer.

    The tensors are packed into one int32 buffer (float32 by its bits),
    copied, and unpacked with their shapes and dtypes.  This is the only
    host transfer of a steady decode step; ``to_host.transfers`` counts the
    calls.  On a CUDA device the copy waits for the device, so it lifts
    PyTorch's sync debug mode for its duration: a caller that sets
    ``torch.cuda.set_sync_debug_mode("error")`` around a step catches any
    other synchronization."""
    parts = []
    for t in tensors:
        flat = t.reshape(-1)
        if t.dtype == torch.float32:
            parts.append(flat.view(torch.int32))
        elif t.dtype == torch.int32:
            parts.append(flat)
        elif t.dtype == torch.bool:
            parts.append(flat.to(torch.int32))
        else:
            raise TypeError(f"to_host takes int32, float32 or bool tensors; got {t.dtype}")
    packed = torch.cat(parts)
    if packed.is_cuda:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            host = packed.cpu().numpy()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    else:
        host = packed.numpy().copy()
    to_host.transfers += 1
    out, i = [], 0
    for t in tensors:
        a = host[i : i + t.numel()].reshape(t.shape)
        i += t.numel()
        out.append(a.view(np.float32) if t.dtype == torch.float32
                   else a != 0 if t.dtype == torch.bool else a)
    return out


to_host.transfers = 0


class Engine:
    def __init__(self, model: Model, *, slots: int, max_len: int,
                 extra_batch: Optional[Dict[str, Any]] = None,
                 cache_layout: str = "dense", page_size: int = 16, num_pages: int = 0,
                 prefix_cache: bool = False, prefill_chunk: int = 0, max_queue: int = 0,
                 preempt: bool = False, faults: Optional[Any] = None,
                 clock: Callable[[], float] = time.time,
                 metrics: Optional[MetricsRegistry] = None,
                 trace: Optional[TraceRecorder] = None, profile: bool = False,
                 on_step: Optional[Callable[["Engine"], None]] = None):
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache_layout {cache_layout!r}")
        self.model = model
        # the one view of the weights every step reads (the model's own
        # tree off a mesh)
        self.params = model.serving_params()
        self.slots = slots
        self.max_len = max_len
        self.layout = cache_layout
        cfg = model.cfg
        self.extra = {k: torch.as_tensor(v, device=model.device)
                      for k, v in (extra_batch or {}).items()}
        # image rows go in front of each prompt only when the batch carries
        # img_embeds; a vision model served text-only has none
        self.n_front = (cfg.num_frontend_tokens
                        if cfg.frontend == "vision_stub" and "img_embeds" in self.extra else 0)
        self.cross_len = cfg.num_frontend_tokens if cfg.is_encoder_decoder else 0
        if cfg.is_encoder_decoder and not self.cross_len:
            # the reference's engine allocates no cross cache here: its dense
            # slot write raises, its paged one drops the cross K/V
            raise ValueError(
                f"{cfg.name}: an encoder-decoder with no frontend rows has no fixed cross "
                "length for the engine's per-slot cross cache; serve it with "
                "repro_torch.launch.serve.generate (a static batch over Model.prefill and "
                "Model.decode_step)")
        # right-padding (prompt buckets, chunk buckets, prefix skips) is sound
        # only when pad rows stay in every real row's future: causal
        # attention, no SSM state carry, no rolling cache
        has_ssm = any(not cfg.is_attn_layer(i) for i in range(cfg.num_layers))
        paddable = cfg.causal and not has_ssm and not cfg.sliding_window
        if has_ssm and (cache_layout == "paged" or prefix_cache or prefill_chunk > 0):
            raise ValueError(
                f"{cfg.name} has SSM layers: it serves over the dense layout with exact-length "
                "prefills — no cache_layout='paged', prefix_cache or prefill_chunk (an SSM "
                "layer's state is per slot and cannot skip or pad prompt rows)")
        self.bucket_prompts = paddable
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        self._incremental = prefix_cache or prefill_chunk > 0
        if self._incremental:
            if cache_layout != "paged":
                raise ValueError("prefix_cache / prefill_chunk require cache_layout='paged'")
            if not paddable or cfg.is_encoder_decoder or self.n_front:
                raise ValueError("prefix_cache / prefill_chunk require a causal "
                                 "attention-only decoder with no frontend rows")
        self.max_queue = int(max_queue)
        self.preempt = bool(preempt)
        if self.preempt and cache_layout != "paged":
            raise ValueError(
                "preempt=True requires cache_layout='paged' — preemption frees "
                "page-pool pressure, which the dense layout has none of"
            )
        self.faults = faults
        self._clock = clock
        # on a mesh: rank 0's clock reading, agreed at each step and submit
        self._agreed: Optional[float] = None
        self.alloc: Optional[PageAllocator] = None
        if cache_layout == "paged":
            if cfg.sliding_window:
                raise ValueError("cache_layout='paged' does not support sliding-window "
                                 "(rolling) caches — use the dense layout")
            # default pool: every slot can hold a full max_len sequence, +1
            # for the reserved null page — admission then only queues on
            # slot pressure, like the dense layout
            num_pages = num_pages or 1 + slots * pages_for(max_len, page_size)
            self.alloc = PageAllocator(num_pages, page_size, slots, max_len,
                                       prefix_cache=prefix_cache)

        # device state, allocated at the first submit (_ensure_state)
        self.cache: Optional[Dict[str, Any]] = None
        self._samp: Dict[str, torch.Tensor] = {}
        self._last_tok: Optional[torch.Tensor] = None
        self._no_inject: Optional[torch.Tensor] = None

        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_left: np.ndarray = np.zeros((slots,), np.int32)
        self.slot_deadline: List[Optional[float]] = [None] * slots
        self.slot_sp: List[Optional[SamplingParams]] = [None] * slots
        self.slot_stop: List[Optional[StopChecker]] = [None] * slots
        self.queue: List[Request] = []
        self.done: List[Request] = []
        # slots mid-prefill, in admission order (FIFO chunk scheduling)
        self._prefilling: List[int] = []
        self._prefill_state: Dict[int, _Prefill] = {}
        # submit order (a preempted request re-queues among the younger
        # ones) and admission recency (the preemption victim is the newest)
        self._next_seq = 0
        self._admit_counter = 0
        self._admit_order: List[int] = [-1] * slots
        self.steps = 0
        self.decode_steps = 0        # steps that ran the lockstep decode
        self.prefill_chunks = 0      # chunks of incremental prefills run
        self._steps_since_progress = 0
        self._progress = False
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "rejected": 0, "timeouts": 0,
            "errors": 0, "cancelled": 0, "preempted": 0, "resumed": 0,
        }

        self.metrics = metrics
        self.trace = trace
        self.profile = bool(profile)
        self.step_timer = StepTimer() if self.profile else None
        self.on_step = on_step
        self._mc = None
        if metrics is not None:
            fam = metrics.counter(
                "engine_requests_total",
                "request lifecycle transitions by event", labels=("event",),
            )
            self._mc = {k: fam.labels(k) for k in self.counters}
            self._g = {
                name: metrics.gauge(f"engine_{name}", help)
                for name, help in (
                    ("queue_depth", "requests waiting for admission"),
                    ("active_slots", "slots holding an in-flight request"),
                    ("prefilling", "slots mid incremental prefill"),
                    ("free_pages", "KV pool pages on the free list"),
                    ("steps_since_progress",
                     "watchdog: engine steps since any request advanced"),
                )
            }
            self._c_steps = metrics.counter("engine_steps_total", "engine scheduler iterations")
            self._c_toks = metrics.counter("engine_tokens_total",
                                           "generated tokens across all requests")
            self._h_ttft = metrics.histogram("engine_ttft_seconds", "submit -> first token",
                                             buckets=LATENCY_BUCKETS)
            self._h_itl = metrics.histogram("engine_itl_seconds",
                                            "per-request mean inter-token latency",
                                            buckets=LATENCY_BUCKETS)
            self._h_queue = metrics.histogram("engine_queue_wait_seconds",
                                              "submit -> slot admission", buckets=LATENCY_BUCKETS)
            self._h_e2e = metrics.histogram("engine_e2e_latency_seconds", "submit -> finish",
                                            buckets=LATENCY_BUCKETS)

    # ---------------------------------------------------------- the clock
    def _tick(self) -> float:
        """Read the clock for a host decision: off a mesh the clock itself;
        on one, rank 0's reading, agreed over the host group, which ``_now``
        returns until the next tick."""
        if not self.model.sharded:
            return self._clock()
        self._agreed = self.model.ctx.agree(self._clock())
        return self._agreed

    def _now(self) -> float:
        """The time a deadline decision reads: the clock off a mesh, the
        step's agreed reading on one."""
        return self._clock() if self._agreed is None else self._agreed

    # ---------------------------------------------------------- telemetry
    def _bump(self, name: str, n: int = 1) -> None:
        """Advance a lifecycle counter in both the ``counters`` dict and the
        metrics registry — one call site per transition, so the two views
        cannot drift."""
        self.counters[name] += n
        if self._mc is not None:
            self._mc[name].inc(n)

    def _emit(self, event: str, req: Optional[Request] = None,
              ts: Optional[float] = None, **data) -> None:
        """Record one lifecycle trace event, stamped by the engine's clock."""
        if self.trace is None:
            return
        self.trace.emit(event, ts=self._clock() if ts is None else ts,
                        uid=req.uid if req is not None else -1, step=self.steps, **data)

    def _observe_gauges(self) -> None:
        self._g["queue_depth"].set(len(self.queue))
        self._g["active_slots"].set(sum(r is not None for r in self.slot_req))
        self._g["prefilling"].set(len(self._prefilling))
        if self.alloc is not None:
            self._g["free_pages"].set(self.alloc.free_pages)
        self._g["steps_since_progress"].set(self._steps_since_progress)

    # ---------------------------------------------------------- device state
    @torch.no_grad()
    def _ensure_state(self) -> None:
        """Allocate the cache (dense buffers, or the page pools and the block
        table) and the per-slot device vectors once.  The numeric sampling
        params live on the device as (B,) vectors;
        ``gen`` is each slot's generation index (tokens emitted so far),
        which keys the counter-hash sampling noise; ``seed`` holds the
        uint32 seed's bits as int32."""
        if self.cache is not None:
            return
        B, dev = self.slots, self.model.device
        if self.alloc is not None:
            cache = self.model.init_cache(B, self.max_len, self.cross_len, layout="paged",
                                          page_size=self.alloc.page_size,
                                          num_pages=self.alloc.num_pages)
        else:
            cache = self.model.init_cache(B, self.max_len, self.cross_len)
        cache["pos"] = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.cache = cache
        self._samp = {
            "temp": torch.zeros((B,), dtype=torch.float32, device=dev),
            "top_k": torch.zeros((B,), dtype=torch.int32, device=dev),
            "top_p": torch.ones((B,), dtype=torch.float32, device=dev),
            "seed": torch.zeros((B,), dtype=torch.int32, device=dev),
            "gen": torch.zeros((B,), dtype=torch.int32, device=dev),
            "active": torch.zeros((B,), dtype=torch.bool, device=dev),
        }
        self._last_tok = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._no_inject = torch.zeros((B,), dtype=torch.bool, device=dev)

    # -------------------------------------------------------------- admin
    def submit(self, req: Request) -> None:
        if req.params is not None and req.params.max_new is not None:
            req.max_new = req.params.max_new
        if req.params is not None and req.params.deadline_ms is not None:
            req.deadline_ms = req.params.deadline_ms
        if req.max_new < 1:
            raise ValueError(f"request {req.uid}: max_new must be >= 1 (got {req.max_new})")
        if len(req.prompt) == 0 and self.n_front == 0:
            raise ValueError(
                f"request {req.uid}: empty prompt — a causal LM has no "
                f"token to condition the first logits on"
            )
        need = len(req.prompt) + self.n_front + req.max_new
        if need > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt+max_new = {need} tokens "
                f"overflows max_len {self.max_len}"
            )
        if self.alloc is not None and not self.alloc.fits_slot(need):
            raise ValueError(
                f"request {req.uid}: {need} tokens can never fit the page "
                f"pool ({self.alloc.num_pages - 1} usable pages of "
                f"{self.alloc.page_size})"
            )
        # bounded backpressure: the typed rejection tells the caller to back
        # off and retry; validation errors above can never succeed and are
        # not rejections
        if self.max_queue and len(self.queue) >= self.max_queue:
            self._bump("rejected")
            self._emit("overload_reject", req, queue_depth=len(self.queue),
                       max_queue=self.max_queue)
            raise EngineOverloaded(req.uid, len(self.queue), self.max_queue)
        self._ensure_state()
        req.t_submit = self._tick()
        req._seq = self._next_seq
        self._next_seq += 1
        self._bump("submitted")
        self.queue.append(req)
        self._emit("submit", req, ts=req.t_submit,
                   prompt_tokens=len(req.prompt), max_new=req.max_new)
        self._emit("queued", req, ts=req.t_submit, queue_depth=len(self.queue))

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
        ``finish``.  No decode cache is allocated.  Encoder-decoder and
        vision-frontend engines refuse: they have no single token-aligned
        hidden sequence to pool."""
        cfg = self.model.cfg
        if cfg.is_encoder_decoder or self.n_front:
            raise ValueError(
                "embed() supports decoder-only text stacks — encoder-decoder and "
                "vision-frontend models have no single token-aligned hidden sequence to pool")
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
                                            torch.as_tensor(lens, device=dev), self.params)
                order.extend(chunk)
                parts.append(emb[: len(chunk)])
        host = torch.cat(parts).cpu().numpy()       # one device->host copy
        out = np.zeros((n, host.shape[-1]), np.float32)
        out[np.asarray(order, np.int64)] = host
        self._bump("completed", n)
        self._emit("finish", embed=True, embedded=n, wall=self._clock() - t0)
        return out

    # ------------------------------------------------------------ admission
    def _bucket(self, n: int) -> int:
        """Pad a prompt length to a power-of-2 bucket (min 8, capped at
        the longest prompt max_len admits after the frontend rows, never
        below n) so prefill runs at few distinct shapes."""
        if not self.bucket_prompts:
            return n
        b = 8
        while b < n:
            b *= 2
        return max(n, min(b, max(self.max_len - self.n_front, 1)))

    def _write_slot(self, slot: int, one_cache: Dict[str, Any], pos: int) -> None:
        """Copy a batch-1 prefilled cache into slot `slot` (dense), in every
        layer of the unit: an attention layer's K/V, an SSM layer's conv
        buffer and state, a cross layer's ``xattn`` K/V and length."""
        for sub, dst in self.cache["layers"].items():
            for kind, leaves in dst.items():
                src = one_cache["layers"][sub][kind]
                for name, buf in leaves.items():
                    buf[:, slot].copy_(src[name][:, 0])
        self.cache["pos"][slot].fill_(pos)

    def _push_table(self) -> None:
        """Copy the block table to the device cache, masking mid-prefill
        slots to the null page: the lockstep decode must neither read nor
        write their half-built pages (their writes land on page 0, which
        belongs to no sequence)."""
        tbl = self.alloc.table
        if self._prefilling:
            tbl = tbl.copy()
            tbl[self._prefilling, :] = NULL_PAGE
        self.cache["block_table"] = torch.tensor(tbl, device=self.model.device)

    def _write_slot_paged(self, slot: int, one_cache: Dict[str, Any], pos: int,
                          pages: np.ndarray, n_tiles: int) -> None:
        """Scatter a batch-1 prefilled cache into `slot`'s pool pages."""
        ids = np.full((n_tiles,), NULL_PAGE, np.int32)
        ids[: min(n_tiles, len(pages))] = pages[:n_tiles]
        write_slot_paged(self.cache["layers"], one_cache["layers"],
                         torch.tensor(ids, device=self.model.device), slot)
        self._push_table()
        self.cache["pos"][slot].fill_(pos)

    def _set_slot_params(self, slot: int, req: Request) -> None:
        """Bind a request's sampling intent to its slot on the host (the
        stop machinery, the deadline, admission recency); ``_emit_first``
        writes the device side."""
        sp = effective_params(req)
        self.slot_sp[slot] = sp
        self.slot_stop[slot] = StopChecker(sp, req.eos_id)
        self.slot_deadline[slot] = self._abs_deadline(req)
        self._admit_order[slot] = self._admit_counter
        self._admit_counter += 1
        first_admission = req.t_admit == 0.0
        req.t_admit = self._clock()
        if self.metrics is not None and first_admission:
            # queue wait is the time to the first admission; a preempted
            # request's re-admission is scheduler churn, not queueing delay
            self._h_queue.observe(req.t_admit - req.t_submit)

    def _abs_deadline(self, req: Request) -> Optional[float]:
        if req.deadline_ms is None:
            return None
        return req.t_submit + req.deadline_ms / 1e3

    def _nan_slots(self) -> List[int]:
        if self.faults is None:
            return []
        return [s for s in self.faults.nan_slots(self.steps) if 0 <= s < self.slots]

    def _emit_first(self, slot: int, logits: torch.Tensor) -> None:
        """Sample the next generated token from the prefill logits on the
        device, at the request's generation index — 0 for a fresh prompt,
        the number of tokens already emitted for a resumed one —, bind the
        slot's device-side sampling state, record the token, and flip the
        slot to lockstep decoding (or finish it at once on stop, budget or
        poisoned logits)."""
        req, sp, s = self.slot_req[slot], self.slot_sp[slot], self._samp
        gen0 = len(req.output) if req.output else 0
        s["temp"][slot].fill_(sp.temperature)
        s["top_k"][slot].fill_(sp.top_k)
        s["top_p"][slot].fill_(sp.top_p)
        s["seed"][slot].fill_(int(np.uint32(sp.seed & 0xFFFFFFFF).view(np.int32)))
        s["gen"][slot].fill_(gen0)
        row = logits[:, -1]
        if slot in self._nan_slots():
            row = torch.full_like(row, float("nan"))
        bad = ~torch.isfinite(row).all(dim=-1)
        row = torch.where(bad[:, None], 0.0, row)
        one = slice(slot, slot + 1)
        tok, logp = ops.sample_tokens(row, s["temp"][one], s["top_k"][one], s["top_p"][one],
                                      s["seed"][one], s["gen"][one],
                                      impl=self.model.cfg.kernel_impl)
        s["gen"][slot].fill_(gen0 + 1)
        s["active"][slot].fill_(True)
        self._last_tok[one].copy_(tok)
        nxt, lp, bad_h = to_host(tok, logp, bad)
        if bad_h[0]:
            # poisoned prefill logits: quarantine this slot only
            req.finish_reason = "error"
            self._emit("quarantine", req, slot=slot, where="prefill")
            self._finish(slot)
            return
        if gen0 == 0:
            req.output = [int(nxt[0])]
            req.logprobs = [float(lp[0])] if sp.logprobs else None
            req.t_first = self._clock()
            if self.metrics is not None:
                self._h_ttft.observe(req.t_first - req.t_submit)
            self._emit("decode", req, ts=req.t_first, slot=slot,
                       ttft_s=req.t_first - req.t_submit)
        else:
            # a preempted request resuming: the replayed prefill gave the
            # logits its next token would have seen, and gen0 keys the same
            # sampling noise, so the token stream continues exactly
            self._bump("resumed")
            self._emit("resume", req, slot=slot, replayed_tokens=gen0)
            req.output.append(int(nxt[0]))
            if req.logprobs is not None:
                req.logprobs.append(float(lp[0]))
        if self.metrics is not None:
            self._c_toks.inc()
        self.slot_left[slot] = req.max_new - len(req.output)
        fin = self.slot_stop[slot].check(req.output, self.slot_left[slot])
        if fin:
            req.finish_reason = fin
            self._finish(slot)

    # ------------------------------------------------------------ preemption
    def _replay_prompt(self, req: Request) -> np.ndarray:
        """The tokens a (possibly preempted) request prefills: the prompt,
        and for a resumed request its generated tokens too, so their K/V
        is rebuilt and decoding continues where it was evicted."""
        if req.output:
            return np.concatenate([req.prompt, np.asarray(req.output, np.int32)])
        return req.prompt

    def _requeue(self, req: Request) -> None:
        """Re-queue a preempted request in submit order among the entries
        behind the blocked head (position 0): the head keeps the front —
        putting the older victim ahead of it would only re-admit the victim
        into the pages it just freed."""
        i = len(self.queue)
        for j in range(1, len(self.queue)):
            if self.queue[j]._seq > req._seq:
                i = j
                break
        self.queue.insert(max(i, 1) if self.queue else 0, req)

    def _release_slot(self, slot: int) -> None:
        """Deactivate `slot` on the device and reset its position."""
        self._samp["active"][slot].fill_(False)
        self.cache["pos"][slot].fill_(0)

    def _preempt_slot(self, slot: int) -> None:
        """Evict an in-flight decode: deactivate the slot, release its pages
        (exclusive ones free; prefix-registered ones park in the evictable
        set, still indexed, so a replay may hit them), and re-queue the
        request.  No sampling state needs saving: the generation index is
        the resume cursor."""
        req = self.slot_req[slot]
        req.preempted += 1
        self._bump("preempted")
        self._emit("preempt", req, slot=slot, generated_tokens=len(req.output or []))
        self.slot_req[slot] = None
        self.slot_left[slot] = 0
        self.slot_sp[slot] = None
        self.slot_stop[slot] = None
        self.slot_deadline[slot] = None
        self._release_slot(slot)
        self.alloc.release(slot)
        self._push_table()
        self._requeue(req)

    def _preempt_for(self, head: Request, need: int, pp: Optional[np.ndarray]) -> bool:
        """Make room for the blocked queue head by evicting the newest
        in-flight decode(s); True iff the head fits afterwards.  Off unless
        ``preempt=True``; a once-preempted request neither triggers nor
        suffers preemption, so the cycle ends; prechecked, so pages are
        never freed without an admission to use them."""
        if not self.preempt or head.preempted:
            return False
        victims = [s for s in range(self.slots)
                   if self.slot_req[s] is not None and s not in self._prefill_state
                   and self.slot_req[s].preempted == 0]
        if not victims:
            return False
        plan = self.alloc.plan(need, pp)
        avail = self.alloc.free_pages + sum(self.alloc.releasable(s) for s in victims)
        if plan.cost > avail:
            return False
        victims.sort(key=lambda s: self._admit_order[s])
        while victims:
            if self.alloc.can_admit(need, self.alloc.plan(need, pp)):
                return True
            self._preempt_slot(victims.pop())    # newest-admitted first
        return self.alloc.can_admit(need, self.alloc.plan(need, pp))

    # ------------------------------------------------------------ admission
    def _admit(self) -> None:
        """Fill free slots from the queue head.  Dense, or paged without
        prefix caching and chunking: batch-1 prefill, slot write, first
        token.  Incremental (paged, prefix cache or chunks): plan and
        allocate the pages (copy-on-write of a fully cached last page) and
        queue the slot for chunked prefill."""
        if self.faults is not None and self.faults.alloc_blocked(self.steps):
            return  # injected allocator outage: no admissions this step
        params = self.params
        dev = self.model.device
        for slot in range(self.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            pp = self._replay_prompt(req)
            L = len(pp)
            # the budget is invariant under replay: prompt + frontend rows
            # + max_new (generated tokens move from the budget to the prompt)
            need = len(req.prompt) + self.n_front + req.max_new
            if self._incremental:
                plan = self.alloc.plan(need, pp)
                if not self.alloc.can_admit(need, plan):
                    if not self._preempt_for(req, need, pp):
                        break  # head-of-line blocking keeps FIFO order
                    plan = self.alloc.plan(need, pp)
                self.queue.pop(0)
                self.alloc.alloc(slot, need, plan)
                if self.alloc.last_cow is not None:
                    # the last page of a fully cached prompt is shared:
                    # privatize it before the last-token recompute writes
                    src, dst = self.alloc.last_cow
                    copy_pages(self.cache["layers"], torch.tensor([src], device=dev),
                               torch.tensor([dst], device=dev))
                self.slot_req[slot] = req
                self._set_slot_params(slot, req)
                self._emit("prefill", req, ts=req.t_admit, slot=slot, prompt_tokens=L,
                           cached_tokens=plan.cached_tokens)
                self._prefill_state[slot] = _Prefill(req=req, prompt=pp,
                                                     done=plan.cached_tokens)
                self._prefilling.append(slot)
                self._push_table()
                self._progress = True
                continue
            if self.alloc is not None and not self.alloc.can_admit(need):
                if not self._preempt_for(req, need, None):
                    break  # head-of-line blocking keeps FIFO order: wait for pages
            self.queue.pop(0)
            Sb = self._bucket(L)
            prompt = np.zeros((Sb,), np.int32)
            prompt[:L] = pp
            batch = {"tokens": torch.as_tensor(prompt[None, :], device=dev), **self.extra}
            Lx = L + self.n_front          # valid decoder-input rows
            n_tiles = (pages_for(Sb + self.n_front, self.alloc.page_size)
                       if self.alloc is not None else 0)
            # the paged layout takes the prefill's K/V in whole page tiles
            buf_len = n_tiles * self.alloc.page_size if self.alloc is not None else self.max_len
            with annotate("engine/prefill", enabled=self.profile):
                logits, one_cache = self.model.prefill(params, batch, buf_len, length=Lx)
            if self.alloc is not None:
                pages = self.alloc.alloc(slot, need)
                self._write_slot_paged(slot, one_cache, Lx, pages, n_tiles)
            else:
                self._write_slot(slot, one_cache, one_cache["pos"])
            del one_cache
            self.slot_req[slot] = req
            self._set_slot_params(slot, req)
            self._emit("prefill", req, ts=req.t_admit, slot=slot, prompt_tokens=L,
                       cached_tokens=0)
            self._progress = True
            self._emit_first(slot, logits)

    def _advance_prefill(self, slot: int) -> None:
        """Run ONE bounded prefill chunk of mid-prefill slot `slot`; when the
        prompt is complete, register its full blocks, make the slot's pages
        visible to the lockstep decode and emit the first token."""
        st = self._prefill_state[slot]
        L = len(st.prompt)
        remaining = L - st.done
        c = min(self.prefill_chunk or remaining, remaining)
        toks = np.zeros((1, self._bucket(c)), np.int32)
        toks[0, :c] = st.prompt[st.done : st.done + c]
        dev = self.model.device
        with annotate("engine/prefill_chunk", enabled=self.profile):
            logits, self.cache["layers"] = self.model.prefill_chunk(
                self.params, self.cache["layers"], torch.as_tensor(toks, device=dev),
                torch.tensor(self.alloc.table[slot : slot + 1], device=dev), st.done, c)
        st.done += c
        self.prefill_chunks += 1
        self._progress = True
        if st.done < L:
            return
        self.alloc.register(slot, st.prompt)
        self._prefilling.remove(slot)
        del self._prefill_state[slot]
        self._push_table()
        self.cache["pos"][slot].fill_(L)
        self._emit_first(slot, logits)

    # ------------------------------------------------------------ finishing
    @torch.no_grad()
    def cancel(self, req: Request) -> None:
        """Abort a queued or in-flight request, releasing its slot at once
        (``finish_reason="cancelled"``; the request still lands in ``done``
        with whatever tokens it produced).  The LLM facade uses it when a
        stream consumer abandons its iterator."""
        # identity, not ==: the dataclass __eq__ compares the numpy prompts
        for i, q in enumerate(self.queue):
            if q is req:
                del self.queue[i]
                req.finish_reason = "cancelled"
                req.t_done = self._clock()
                self._bump("cancelled")
                self._emit("finish", req, ts=req.t_done, reason="cancelled",
                           tokens=len(req.output or []))
                self.done.append(req)
                return
        for slot in range(self.slots):
            if self.slot_req[slot] is req:
                if slot in self._prefill_state:
                    del self._prefill_state[slot]
                    self._prefilling.remove(slot)
                req.finish_reason = "cancelled"
                self._finish(slot)
                return

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        if not req.finish_reason:
            req.finish_reason = "length"
        reason = req.finish_reason
        if reason == "timeout":
            self._bump("timeouts")
        elif reason == "error":
            self._bump("errors")
        elif reason == "cancelled":
            self._bump("cancelled")
        else:
            self._bump("completed")
        req.t_done = self._clock()
        n_out = len(req.output or [])
        if self.metrics is not None:
            self._h_e2e.observe(req.t_done - req.t_submit)
            if req.t_first and n_out >= 2:
                self._h_itl.observe((req.t_done - req.t_first) / (n_out - 1))
        self._emit("finish", req, ts=req.t_done, slot=slot, reason=reason, tokens=n_out)
        self.done.append(req)
        self.slot_req[slot] = None
        self.slot_left[slot] = 0
        self.slot_sp[slot] = None
        self.slot_stop[slot] = None
        self.slot_deadline[slot] = None
        # deactivate and reset pos, so the slot comes back clean at once
        self._release_slot(slot)
        if self.alloc is not None:
            self.alloc.release(slot)
            self._push_table()

    def _expire_queued(self) -> None:
        """Finish queued requests whose deadline passed before they ever
        ran (``finish_reason="timeout"``, no tokens)."""
        if not self.queue:
            return
        now = self._now()
        kept: List[Request] = []
        for req in self.queue:
            dl = self._abs_deadline(req)
            if dl is not None and now >= dl:
                req.finish_reason = "timeout"
                req.t_done = now
                self._bump("timeouts")
                self._emit("timeout", req, ts=now, where="queue")
                self._emit("finish", req, ts=now, reason="timeout", tokens=0)
                self.done.append(req)
            else:
                kept.append(req)
        self.queue = kept

    def _expire_in_flight(self) -> None:
        """Release in-flight requests past their deadline at the step
        boundary (they keep the tokens produced so far)."""
        if all(d is None for d in self.slot_deadline):
            return
        now = self._now()
        for s in range(self.slots):
            dl = self.slot_deadline[s]
            if dl is None or self.slot_req[s] is None or now < dl:
                continue
            if s in self._prefill_state:
                del self._prefill_state[s]
                self._prefilling.remove(s)    # _finish re-pushes the table
            self.slot_req[s].finish_reason = "timeout"
            self._emit("timeout", self.slot_req[s], ts=now, where="in_flight", slot=s)
            self._finish(s)

    # --------------------------------------------------------------- step
    def _decode(self, inject: torch.Tensor):
        """One lockstep decode iteration with token selection on the device:
        decode, idle-slot position reset, NaN sentinel (an injected or
        organic non-finite row is flagged and zeroed before the sampler, so
        it cannot reach another slot's token), sampling, and the generation
        index bump.  Returns device (tok, logp, bad)."""
        s = self._samp
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    self._last_tok[:, None])
        # idle slots stepped in lockstep: reset their positions (their
        # writes touched no live data)
        self.cache["pos"] = torch.where(s["active"], self.cache["pos"], 0)
        row = torch.where(inject[:, None], float("nan"), logits[:, -1])
        bad = s["active"] & ~torch.isfinite(row).all(dim=-1)
        row = torch.where(bad[:, None], 0.0, row)
        # idle slots read as greedy whatever request last held them, so a
        # retired sampled request does not keep the sampler off its greedy
        # path
        nxt, logp = ops.sample_tokens(row, torch.where(s["active"], s["temp"], 0.0),
                                      s["top_k"], s["top_p"], s["seed"], s["gen"],
                                      impl=self.model.cfg.kernel_impl)
        nxt = torch.where(s["active"], nxt, 0)
        s["gen"] += s["active"].to(torch.int32)
        return nxt, logp, bad

    def _span(self, name: str):
        """The step timer's span ``name``; nothing when profiling is off."""
        return self.step_timer.span(name) if self.step_timer is not None else contextlib.nullcontext()

    @torch.no_grad()
    def step(self) -> int:
        """Expire queued deadlines, admit (possibly preempting), advance
        prefill chunks, run one lockstep decode over the decoding slots,
        expire in-flight deadlines.  Returns the number of slots decoded.

        With decodes in flight, only the longest-waiting mid-prefill slot
        advances, by ONE chunk, per step, so a long prompt delays each
        decode step by at most one chunk; with none, every mid-prefill slot
        advances a chunk."""
        self.steps += 1
        self._progress = False
        done0 = len(self.done)
        if self.model.sharded:
            self._tick()
        self._expire_queued()
        self._admit()
        if self._prefilling:
            decoding = any(self.slot_req[s] is not None and s not in self._prefill_state
                           for s in range(self.slots))
            for slot in (self._prefilling[:1] if decoding else list(self._prefilling)):
                self._advance_prefill(slot)
        active = [s for s in range(self.slots)
                  if self.slot_req[s] is not None and s not in self._prefill_state]
        if active:
            inject = self._no_inject
            bad_slots = self._nan_slots()
            if bad_slots:
                inject = torch.zeros_like(self._no_inject)
                for b in bad_slots:
                    inject[b].fill_(True)
            with self._span("decode"), annotate("engine/decode", enabled=self.profile):
                tok_d, logp_d, bad_d = self._decode(inject)
            with self._span("host_sync"):
                self._last_tok = tok_d
                nxt, logps, bads = to_host(tok_d, logp_d, bad_d)   # the step's one transfer
            self.decode_steps += 1
            emitted = 0
            for s in active:
                req = self.slot_req[s]
                if bads[s]:
                    # non-finite logits in THIS slot only: quarantine it
                    req.finish_reason = "error"
                    self._emit("quarantine", req, slot=s, where="decode")
                    self._finish(s)
                    continue
                req.output.append(int(nxt[s]))
                emitted += 1
                if req.logprobs is not None:
                    req.logprobs.append(float(logps[s]))
                self.slot_left[s] -= 1
                fin = self.slot_stop[s].check(req.output, self.slot_left[s])
                if fin:
                    req.finish_reason = fin
                    self._finish(s)
            if self.metrics is not None and emitted:
                self._c_toks.inc(emitted)
        self._expire_in_flight()
        if active or self._progress or len(self.done) != done0:
            self._steps_since_progress = 0
        else:
            self._steps_since_progress += 1
        if self.metrics is not None:
            self._c_steps.inc()
            self._observe_gauges()
        if self.on_step is not None:
            self.on_step(self)
        return len(active)

    # -------------------------------------------------------------- health
    def health(self) -> EngineHealth:
        """Host-side liveness snapshot (no device sync)."""
        return EngineHealth(
            queue_depth=len(self.queue),
            slots=self.slots,
            active_slots=sum(r is not None for r in self.slot_req),
            prefilling=len(self._prefilling),
            free_pages=self.alloc.free_pages if self.alloc is not None else None,
            total_pages=self.alloc.num_pages - 1 if self.alloc is not None else None,
            steps=self.steps,
            steps_since_progress=self._steps_since_progress,
            counters=dict(self.counters),
        )

    def run(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        return self.done
