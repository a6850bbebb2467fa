"""Deterministic fault injection for the serving engine.

The port's own copy of the reference's ``repro.serving.faults``:

  * **NaN logits** — at step N, slot S's decode (or admission first-token)
    logits are poisoned with NaN on the device, exercising the engine's
    non-finite sentinel: the slot finishes with ``finish_reason="error"``
    and every other slot's tokens are unchanged.
  * **Allocator outages** — for a window of steps the engine admits
    nothing; queued requests wait (or time out on their deadlines).
  * **Crash-and-rebuild** — :func:`crash_and_rebuild` drops the engine at
    step N (all in-flight state lost) and rebuilds a fresh one from the
    unfinished requests.  A crash is not a preemption: pre-crash tokens
    are discarded and survivors re-run from their prompts; counter-hash
    sampling still makes their final outputs token-identical to a
    crash-free run.
  * **Deadline storms** — :func:`deadline_storm` stamps a seeded random
    subset of requests with tight deadlines, driving the timeout path
    under load.

Schedules are keyed on the engine's own step counter (``Engine.steps``,
1-based), so a plan replays identically run to run; :meth:`FaultPlan.seeded`
draws one from a seed with numpy, as the reference does.

    plan = FaultPlan(nan={5: (1,)}, alloc_outages=((8, 3),))
    llm = LLM(model, slots=4, max_len=256, faults=plan)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class FaultPlan:
    """``nan`` maps engine step -> slot ids whose logits are poisoned at
    that step; ``alloc_outages`` holds ``(start_step, duration)`` windows
    during which admission is blocked; ``crash_at`` names the step at which
    :func:`crash_and_rebuild` drops the engine (the engine itself never
    reads it)."""

    nan: Dict[int, Tuple[int, ...]] = dataclasses.field(default_factory=dict)
    alloc_outages: Tuple[Tuple[int, int], ...] = ()
    crash_at: Optional[int] = None

    def nan_slots(self, step: int) -> Tuple[int, ...]:
        """Slot ids whose logits are NaN-poisoned at engine step `step`."""
        return self.nan.get(step, ())

    def alloc_blocked(self, step: int) -> bool:
        """True while an injected allocator outage covers `step`."""
        return any(s <= step < s + d for s, d in self.alloc_outages)

    def should_crash(self, step: int) -> bool:
        return self.crash_at is not None and step >= self.crash_at

    @classmethod
    def seeded(cls, seed: int, *, horizon: int = 48, slots: int = 4,
               nan_events: int = 1, outages: int = 1, max_outage: int = 4,
               crash: bool = False) -> "FaultPlan":
        """A reproducible random plan: same seed, same faults, forever.

        ``horizon`` bounds the steps at which events may fire; size it to
        the workload (an event past the last engine step never fires —
        harmless, but tests asserting "the fault fired" should keep the
        horizon inside their step budget)."""
        rng = np.random.default_rng(seed)
        nan: Dict[int, set] = {}
        for _ in range(nan_events):
            step = int(rng.integers(2, max(horizon, 3)))
            nan.setdefault(step, set()).add(int(rng.integers(0, slots)))
        outs = tuple(
            (int(rng.integers(1, max(horizon, 2))),
             int(rng.integers(1, max_outage + 1)))
            for _ in range(outages)
        )
        crash_at = int(rng.integers(3, max(horizon, 4))) if crash else None
        return cls(
            nan={s: tuple(sorted(v)) for s, v in nan.items()},
            alloc_outages=outs,
            crash_at=crash_at,
        )


def deadline_storm(requests: Sequence, *, seed: int, fraction: float = 0.5,
                   deadline_ms: Tuple[float, float] = (1.0, 50.0)) -> List[int]:
    """Stamp a seeded random subset of `requests` with tight deadlines
    (in place, before submit).  Returns the stormed uids — the chaos
    suite checks each either finished normally before its deadline or
    carries ``finish_reason="timeout"``, never a hung slot."""
    rng = np.random.default_rng(seed)
    hit: List[int] = []
    for r in requests:
        if rng.random() < fraction:
            r.deadline_ms = float(rng.uniform(*deadline_ms))
            hit.append(r.uid)
    return hit


def crash_and_rebuild(make_engine: Callable[[], "object"],
                      requests: Sequence, *,
                      max_steps: int = 10_000) -> Tuple[List, bool]:
    """Drive `requests` to completion across a hard engine crash.

    ``make_engine()`` builds a fresh engine (its ``faults`` plan decides
    ``crash_at``).  All requests are submitted; when the engine's step
    counter reaches the plan's crash step, the engine object is dropped
    on the floor — in-flight KV, queue and device state all lost — and a
    rebuilt engine (faults cleared: the same plan would just re-crash)
    takes over every request that had not finished.  Survivors are reset
    to their pre-submit state (generated tokens are NOT carried over —
    unlike preemption, a crash loses the cache pages that made the
    partial output resumable) and re-run from their prompts.

    Returns ``(done_requests, crashed)`` where `done_requests` holds
    every input request that reached a finish reason, in completion
    order."""
    eng = make_engine()
    plan = getattr(eng, "faults", None)
    for r in requests:
        eng.submit(r)
    done: List = []
    crashed = False
    steps = 0
    while (eng.queue or any(s is not None for s in eng.slot_req)) \
            and steps < max_steps:
        eng.step()
        steps += 1
        if (not crashed and plan is not None
                and plan.should_crash(eng.steps)):
            crashed = True
            done.extend(eng.done)
            survivors = [r for r in requests if not r.finish_reason]
            eng = make_engine()
            eng.faults = None
            for r in survivors:
                r.output = None
                r.logprobs = None
                r.preempted = 0
                r.t_first = 0.0
                r.t_done = 0.0
                eng.submit(r)
    # plain concat, no ==-dedup (Request.__eq__ tuple-compares numpy
    # prompts and raises): pre-crash finishers live only in the first
    # engine's done list, post-crash ones only in the second's
    done.extend(eng.done)
    return done, crashed
