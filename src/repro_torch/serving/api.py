"""``LLM`` — the serving facade of the port.

    model = build_model(dataclasses.replace(get_config("qwen2-7b"),
                                            param_dtype="bfloat16"))   # on the GPU
    llm = LLM(model, slots=32, max_len=2048)                     # dense KV cache
    outs = llm.generate(prompts, SamplingParams(temperature=0.8, top_k=40))
    paged = LLM(model, slots=32, max_len=2048, cache_layout="paged",
                prefix_cache=True, prefill_chunk=512)           # page pool
    for chunk in llm.stream(prompts, SamplingParams(max_new=64)):
        print(chunk.index, chunk.token)

    esm = LLM(build_model(get_config("esm2-650m")), slots=32, max_len=1024)
    vecs = esm.embed([tok.encode(seq) for seq in sequences])   # (n, 1280) fp32

The port's copy of the reference's ``repro.serving.api``, for the dense
and the paged cache layouts:

* ``LLM.generate(prompts, params)`` — batch completion: submits every
  prompt with its own ``SamplingParams`` (one shared instance or a
  per-prompt list), drives the engine to completion, and returns
  ``Completion`` records in input order;
* ``LLM.stream(prompts, params)`` — a generator of one ``StreamChunk``
  per generated token, in the order the lockstep engine produces them;
* ``LLM.embed(prompts)`` — batched embedding extraction.

The model holds its own weights, so the facade takes no separate param
tree (the reference's takes one).  Serve from bf16 parameters: with the
default fp32 ``param_dtype`` every decode step re-reads and re-casts the
fp32 master weights.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.config import ServeConfig
from repro_torch.serving.engine import Engine, EngineOverloaded, Request
from repro_torch.serving.sampling import SamplingParams

ParamsArg = Union[None, SamplingParams, Sequence[Optional[SamplingParams]]]


@dataclasses.dataclass
class Completion:
    """One finished request, in the order its prompt was passed in.

    ``finish_reason`` extends beyond the happy path: ``"stop"`` /
    ``"length"`` (normal), ``"timeout"`` (deadline passed — ``tokens``
    holds whatever was produced, possibly nothing), ``"error"`` (the
    request's logits went non-finite and its slot was quarantined), and
    ``"overloaded"`` (rejected at submit by the engine's bounded queue —
    the request never ran; retriable).  Degraded outcomes are data, not
    exceptions: one saturated engine must not turn a whole batch call
    into a stack trace.

    Timings: ``ttft_s`` is ``None`` — not ``0.0`` — when no token was
    ever produced (queued timeout, overload rejection, a first-token
    quarantine): "instant first token" and "no first token" are
    different facts, and SLO math must not average them together.
    ``queue_wait_s`` (submit -> first slot admission) is reported
    alongside, and is also ``None`` for requests that never reached a
    slot."""

    index: int
    tokens: List[int]
    finish_reason: str
    logprobs: Optional[List[float]] = None
    ttft_s: Optional[float] = None        # submit -> first token; None if none
    queue_wait_s: Optional[float] = None  # submit -> admission; None if never
    latency_s: float = 0.0                # submit -> done


@dataclasses.dataclass
class StreamChunk:
    """One newly decoded token of one in-flight request."""

    index: int
    token: int
    logprob: Optional[float] = None
    done: bool = False
    finish_reason: str = ""


class LLM:
    """Generate / stream / embed facade over the serving engine.

    Construction mirrors ``Engine`` (or use ``LLM.from_config`` with a
    ``ServeConfig``).  ``default_params`` applies to prompts submitted
    without explicit params; it defaults to greedy.
    """

    def __init__(self, model, *, slots: int = 4, max_len: int = 512,
                 cache_layout: str = "dense", page_size: int = 16, num_pages: int = 0,
                 prefix_cache: bool = False, prefill_chunk: int = 0, max_queue: int = 0,
                 preempt: bool = False, faults: Optional[Any] = None,
                 default_params: Optional[SamplingParams] = None,
                 clock: Callable[[], float] = time.time,
                 metrics: Optional[Any] = None, trace: Optional[Any] = None,
                 profile: bool = False):
        self.engine = Engine(
            model, slots=slots, max_len=max_len, cache_layout=cache_layout,
            page_size=page_size, num_pages=num_pages, prefix_cache=prefix_cache,
            prefill_chunk=prefill_chunk, max_queue=max_queue, preempt=preempt, faults=faults,
            clock=clock, metrics=metrics, trace=trace, profile=profile,
        )
        self.default_params = default_params or SamplingParams()
        self._uid = 0

    @classmethod
    def from_config(cls, model, sc: ServeConfig, *, slots: Optional[int] = None,
                    **kw) -> "LLM":
        """Build from a ``ServeConfig``: its layout and scheduling fields map
        onto the engine, its sampling knobs (temperature, top_k, top_p, seed,
        deadline_ms) become the default ``SamplingParams``; extra keyword
        args (``num_pages``, ``clock``, ``metrics``, ``trace``, ``faults``,
        ``profile``) pass through to the constructor."""
        return cls(
            model,
            slots=slots if slots is not None else sc.batch_size,
            max_len=sc.max_seq_len, cache_layout=sc.cache_layout,
            page_size=sc.page_size, prefix_cache=sc.prefix_cache,
            prefill_chunk=sc.prefill_chunk, max_queue=sc.max_queue, preempt=sc.preempt,
            default_params=SamplingParams(
                temperature=sc.temperature, top_k=sc.top_k, top_p=sc.top_p,
                seed=sc.seed, deadline_ms=sc.deadline_ms,
            ),
            **kw,
        )

    # ---------------------------------------------------------- internals
    def _submit(self, prompts, params: ParamsArg) -> List[Optional[Request]]:
        """Submit every prompt; returns one entry per prompt, ``None``
        where the engine's bounded queue rejected it (surfaced to the
        caller as an ``"overloaded"`` outcome — the accepted prompts in
        the same batch still run).  Validation errors, by contrast, abort
        the whole call: they can never succeed on retry, and partial
        silent submission would leave orphans decoding inside later
        calls."""
        if isinstance(params, SamplingParams) or params is None:
            plist: List[Optional[SamplingParams]] = [params] * len(prompts)
        else:
            plist = list(params)
            if len(plist) != len(prompts):
                raise ValueError(
                    f"got {len(plist)} SamplingParams for {len(prompts)} prompts"
                )
        reqs: List[Optional[Request]] = []
        try:
            for prompt, sp in zip(prompts, plist):
                req = Request(
                    uid=self._uid,
                    prompt=np.asarray(prompt, np.int32),
                    params=sp or self.default_params,
                )
                self._uid += 1
                try:
                    self.engine.submit(req)
                except EngineOverloaded:
                    reqs.append(None)
                    continue
                reqs.append(req)
        except Exception:
            # mid-batch validation failure: withdraw what was already
            # queued, or it would silently decode inside the next call
            for r in reqs:
                if r is not None:
                    self.engine.cancel(r)
            raise
        return reqs

    # ------------------------------------------------------------ public
    def generate(self, prompts, params: ParamsArg = None,
                 max_steps: int = 100_000) -> List[Completion]:
        """Run every prompt to completion; results in input order."""
        reqs = self._submit(prompts, params)
        self.engine.run(max_steps=max_steps)
        outs = []
        for i, req in enumerate(reqs):
            if req is None:
                # bounded-queue rejection at submit: a typed outcome, so
                # one saturated engine degrades per-request, not per-call
                outs.append(Completion(
                    index=i, tokens=[], finish_reason="overloaded",
                ))
                continue
            if not req.finish_reason:
                # same leak-prevention as stream(): an overrun must not
                # leave orphans decoding inside later calls
                for r in reqs:
                    if r is not None and not r.finish_reason:
                        self.engine.cancel(r)
                raise RuntimeError(
                    f"request {req.uid} unfinished after {max_steps} steps"
                )
            outs.append(Completion(
                index=i, tokens=list(req.output or []),
                finish_reason=req.finish_reason, logprobs=req.logprobs,
                # None, not 0.0, when no token / no admission ever
                # happened — see the Completion docstring
                ttft_s=(req.t_first - req.t_submit) if req.t_first else None,
                queue_wait_s=(
                    (req.t_admit - req.t_submit) if req.t_admit else None
                ),
                latency_s=req.t_done - req.t_submit,
            ))
        return outs

    def embed(self, prompts) -> np.ndarray:
        """Batched embedding extraction through the engine: token prompts
        -> ``(n, d_model)`` float32 masked-mean-pooled vectors, in input
        order.  Prompts dispatch in length-bucketed device batches and
        the result comes back in one bulk transfer; lifecycle counters
        and trace events flow through the engine's telemetry like any
        generate call.  See ``Engine.embed``."""
        return self.engine.embed(prompts)

    def stream(self, prompts, params: ParamsArg = None,
               max_steps: int = 100_000) -> Iterator[StreamChunk]:
        """Yield tokens as the engine decodes them, interleaved across
        requests at iteration granularity (the continuous-batching
        analogue of server-sent streaming).  Abandoning the iterator
        (break / close) cancels the remaining in-flight requests and
        frees their slots/pages.

        Submission (and its validation errors) happens HERE, not at the
        first ``next()`` — ``stream`` is not itself a generator, it
        returns one, so a too-long prompt raises at the call site and
        the TTFT clocks start at call time."""
        reqs = self._submit(prompts, params)
        return self._stream(reqs, max_steps)

    def _stream(self, reqs: List[Optional[Request]],
                max_steps: int) -> Iterator[StreamChunk]:
        emitted = [0] * len(reqs)
        closed = [False] * len(reqs)
        try:
            # overload rejections are known before any engine step: emit
            # their terminal chunks up front (token=-1, no tokens exist)
            for i, req in enumerate(reqs):
                if req is None:
                    closed[i] = True
                    yield StreamChunk(
                        index=i, token=-1, done=True,
                        finish_reason="overloaded",
                    )
            for _ in range(max_steps):
                self.engine.step()
                for i, req in enumerate(reqs):
                    if req is None:
                        continue
                    out = req.output or []
                    while emitted[i] < len(out):
                        j = emitted[i]
                        emitted[i] += 1
                        last = emitted[i] == len(out)
                        fin = req.finish_reason if last else ""
                        closed[i] = closed[i] or bool(fin)
                        yield StreamChunk(
                            index=i, token=out[j],
                            logprob=(req.logprobs[j] if req.logprobs else None),
                            done=bool(fin), finish_reason=fin,
                        )
                    if req.finish_reason and not closed[i]:
                        # finished without a fresh token (queued timeout,
                        # quarantined first token): the consumer still
                        # needs a terminal chunk to stop waiting on i
                        closed[i] = True
                        yield StreamChunk(
                            index=i, token=-1, done=True,
                            finish_reason=req.finish_reason,
                        )
                if all(closed):
                    return
            raise RuntimeError(
                f"stream unfinished after {max_steps} engine steps"
            )
        finally:
            # consumer broke out / closed the generator: cancel whatever
            # is still in flight so orphaned requests don't keep decoding
            # (and holding slots) inside later generate()/stream() calls
            for req in reqs:
                if req is not None and not req.finish_reason:
                    self.engine.cancel(req)
