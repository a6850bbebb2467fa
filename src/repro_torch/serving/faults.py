"""Deterministic fault injection for the serving engine.

The port's own copy of the two hooks of the reference's
``repro.serving.faults.FaultPlan`` that the dense engine reads:

  * **NaN logits** — at step N, slot S's decode (or admission first-token)
    logits are poisoned with NaN on the device, exercising the engine's
    non-finite sentinel: the slot finishes with ``finish_reason="error"``
    and every other slot's tokens are unchanged.
  * **Allocator outages** — for a window of steps the engine admits
    nothing; queued requests wait (or time out on their deadlines).

Schedules are keyed on the engine's own step counter (``Engine.steps``,
1-based), so a plan replays identically run to run.  The reference's
crash-and-rebuild and deadline-storm helpers come with the paged slice.

    plan = FaultPlan(nan={5: (1,)}, alloc_outages=((8, 3),))
    llm = LLM(model, slots=4, max_len=256, faults=plan)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass
class FaultPlan:
    """``nan`` maps engine step -> slot ids whose logits are poisoned at
    that step; ``alloc_outages`` holds ``(start_step, duration)`` windows
    during which admission is blocked."""

    nan: Dict[int, Tuple[int, ...]] = dataclasses.field(default_factory=dict)
    alloc_outages: Tuple[Tuple[int, int], ...] = ()

    def nan_slots(self, step: int) -> Tuple[int, ...]:
        """Slot ids whose logits are NaN-poisoned at engine step `step`."""
        return self.nan.get(step, ())

    def alloc_blocked(self, step: int) -> bool:
        """True while an injected allocator outage covers `step`."""
        return any(s <= step < s + d for s, d in self.alloc_outages)
