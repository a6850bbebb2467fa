"""Per-request sampling intent: ``SamplingParams`` + stop machinery.

The port's own copy of the reference's ``repro.serving.sampling`` (pure
Python).  A ``SamplingParams`` rides on every request, so a serving batch
can mix greedy traffic with sampled traffic in one lockstep decode step.
The numeric fields (temperature, top_k, top_p, seed) live on the device as
per-slot vectors consumed by the fused sampler
(``kernels/ops.py::sample_tokens``); the stop fields are host-side
bookkeeping applied to the step's one host transfer.

Determinism: ``seed`` keys a counter-based hash indexed by the request's
own generation step, so a fixed-seed request reproduces the same tokens
whatever slots and batch it shares a decode step with.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request wants its tokens chosen and when to stop.

    ``temperature <= 0`` is greedy argmax (the default — token-identical
    to the pre-v2 engine).  ``top_k=0`` and ``top_p=1.0`` disable the
    respective filters.  ``max_new=None`` inherits the carrying
    ``Request``'s budget (so a legacy call site can attach sampling
    intent without its explicit ``max_new`` being silently replaced);
    facade requests default to 32.  ``stop_token_ids`` stop on a single
    generated token; ``stop_sequences`` stop when the generated suffix
    matches a multi-token pattern (matched tokens stay in the output,
    like eos).  ``logprobs`` records the chosen token's log-probability
    per step.  ``deadline_ms`` is a wall-clock SLO measured from submit:
    a request still queued past its deadline finishes with
    ``finish_reason="timeout"`` without ever running, and an in-flight
    request past it is released at the next engine step boundary with
    whatever tokens it produced (``None`` = no deadline).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    logprobs: bool = False
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0 (got {self.temperature})")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0 (got {self.deadline_ms})"
            )
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (got {self.top_k})")
        if not 0.0 < self.top_p <= 1.0 + 1e-9:
            raise ValueError(f"top_p must be in (0, 1] (got {self.top_p})")
        if self.max_new is not None and self.max_new < 1:
            raise ValueError(f"max_new must be >= 1 (got {self.max_new})")
        # normalize stop containers to hashable tuples
        object.__setattr__(
            self, "stop_token_ids", tuple(int(t) for t in self.stop_token_ids)
        )
        seqs = tuple(tuple(int(t) for t in s) for s in self.stop_sequences)
        if any(len(s) == 0 for s in seqs):
            raise ValueError("stop_sequences entries must be non-empty")
        object.__setattr__(self, "stop_sequences", seqs)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


class StopChecker:
    """Host-side stop evaluation for one request.

    Built once at admission from the request's effective params (legacy
    ``Request.eos_id >= 0`` folds into the stop-token set; ``eos_id=-1``
    keeps the never-stop semantics).  ``check`` is called after every
    emitted token with the full generated output and the remaining
    budget; it returns a finish reason (``"stop"`` / ``"length"``) or
    ``""`` to keep decoding.  Matched stop tokens/sequences remain in
    the output (same contract as the legacy eos path).
    """

    def __init__(self, params: SamplingParams, eos_id: int = -1):
        ids = set(params.stop_token_ids)
        if eos_id >= 0:
            ids.add(int(eos_id))
        self.stop_ids = frozenset(ids)
        self.stop_seqs: Tuple[List[int], ...] = tuple(
            list(s) for s in params.stop_sequences
        )

    def check(self, output: Sequence[int], left: int) -> str:
        if output and output[-1] in self.stop_ids:
            return "stop"
        for s in self.stop_seqs:
            if len(output) >= len(s) and list(output[-len(s):]) == s:
                return "stop"
        if left <= 0:
            return "length"
        return ""


def effective_params(req) -> SamplingParams:
    """The params a request decodes under.

    ``Request.params`` wins when present; a legacy request (no params)
    maps to greedy with its ``max_new`` budget — the exact pre-v2
    behavior, which keeps old ``Engine(...)`` call sites working.
    """
    if getattr(req, "params", None) is not None:
        return req.params
    return SamplingParams(max_new=req.max_new)
