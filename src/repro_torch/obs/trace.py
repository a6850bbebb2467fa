"""Request-lifecycle tracing: a bounded ring-buffer span recorder.

The port's own copy of the reference's ``repro.obs.trace`` (pure Python).

The serving engine emits one structured event per lifecycle transition —
``submit -> queued -> prefill -> decode -> finish`` on the happy path,
plus ``preempt`` / ``resume``, ``quarantine``, ``timeout`` and
``overload_reject`` on the degraded paths — into a fixed-capacity ring
buffer.  Events are plain host tuples at emit time (no JSON, no I/O, no
device traffic on the hot path); serialization happens only when the
trace is exported.

Determinism contract: the recorder never reads a clock of its own — the
engine stamps every event with its *injectable* clock (``Engine(clock=)``,
the same source its deadline machinery uses).  A seeded ``FaultPlan`` run
driven by a fake clock therefore produces a byte-identical JSONL trace
across runs, which turns "what did
the engine do during the outage" from archaeology into a golden file.

JSONL schema (one object per line, keys sorted, compact separators):

    {"event": <str>, "step": <int>, "ts": <float>, "uid": <int>, ...}

``event`` is one of :data:`EVENTS`; ``step`` is the engine step counter
at emit time (1-based, 0 outside any step); ``uid`` is the request id
(-1 for engine-scoped events); extra keyword fields ride along verbatim
(slot, reason, queue_depth, cached_tokens, ...).
"""
from __future__ import annotations

import collections
import json
import os
from typing import Deque, Dict, Iterator, List, Tuple

# the full lifecycle vocabulary; emit() rejects anything else so a typo'd
# event name fails the producer, not every downstream consumer
EVENTS = frozenset({
    "submit",            # request passed validation and was accepted
    "queued",            # request appended to the admission queue
    "prefill",           # admitted to a slot; prefill begins (or resumes)
    "decode",            # first token emitted; slot flipped to lockstep decode
    "finish",            # terminal: finish_reason + token count ride along
    "preempt",           # evicted under page pressure, re-queued
    "resume",            # replayed prefill caught up; decoding continues
    "quarantine",        # non-finite logits; slot isolated
    "timeout",           # deadline expired (queued or in flight)
    "overload_reject",   # bounded queue full; typed rejection at submit
})


class TraceRecorder:
    """Fixed-capacity lifecycle event recorder (host-side, allocation-light).

    ``capacity`` bounds memory: older events fall off the front — the
    serving trace is a flight recorder, not an unbounded log.  ``emit``
    stores a ``(ts, step, uid, event, extra)`` tuple; exporting renders
    JSONL with sorted keys and compact separators so equal event streams
    produce equal bytes."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.capacity = capacity
        self._buf: Deque[Tuple[float, int, int, str, tuple]] = \
            collections.deque(maxlen=capacity)
        self.emitted = 0      # total ever emitted (dropped = emitted - len)

    def emit(self, event: str, *, ts: float, uid: int = -1, step: int = 0,
             **data) -> None:
        if event not in EVENTS:
            raise ValueError(
                f"unknown trace event {event!r} (known: {sorted(EVENTS)})"
            )
        # sort extras once at emit so export is a pure render
        self._buf.append(
            (float(ts), int(step), int(uid), event, tuple(sorted(data.items())))
        )
        self.emitted += 1

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._buf)

    def events(self) -> List[Dict]:
        """Decoded events, oldest first."""
        return [
            {"ts": ts, "step": step, "uid": uid, "event": ev, **dict(extra)}
            for ts, step, uid, ev, extra in self._buf
        ]

    def lines(self) -> Iterator[str]:
        for e in self.events():
            yield json.dumps(e, sort_keys=True, separators=(",", ":"))

    def to_jsonl(self) -> str:
        return "".join(line + "\n" for line in self.lines())

    def write(self, path: str) -> None:
        """Atomic JSONL dump (tmp + ``os.replace``)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_jsonl())
        os.replace(tmp, path)

    def clear(self) -> None:
        self._buf.clear()
        self.emitted = 0
