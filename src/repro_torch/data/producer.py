"""Background batch producer (the port's copy of the reference's
``data/producer.py``): batch construction on a worker thread, overlapped
with the device step.

The host pipelines (``MLMBatches``/``CLMBatches``) are numpy; the
trainer's ``_DevicePrefetch`` overlaps the host-to-device copy, and
``BackgroundProducer`` moves the building of the batches onto one worker
thread behind a bounded queue (numpy releases the GIL in its hot loops).

* **Order** — one worker drains ``iter(pipeline)`` in order: the consumer
  sees the batches the bare pipeline would give.
* **Cursor** — the worker snapshots ``pipeline.state_dict()`` after each
  draw, and the snapshot rides the queue with its batch; ``state_dict()``
  is the cursor of the last *consumed* batch (and the consumed count), so
  a checkpoint never includes the batches the worker drew ahead.
  ``load_state_dict`` is refused once iteration has begun.
* **Shutdown** — ``close()`` (or the context manager) stops the worker,
  also when it is blocked on a full queue.
* **Errors** — an exception in the worker re-raises in the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

_STOP_POLL_S = 0.1


class BackgroundProducer:
    """Threaded prefetch in front of a host batch pipeline.  ``depth``
    bounds the queue: the worker stays at most ``depth`` batches ahead.
    The worker starts at the first ``__next__``."""

    def __init__(self, pipeline, *, depth: int = 4):
        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        self.pipeline = pipeline
        self.depth = int(depth)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.consumed = 0
        self._cursor = self._snapshot()   # the pipeline's state before any draw
        self._closed = False
        self._ended = False

    def _snapshot(self):
        sd = getattr(self.pipeline, "state_dict", None)
        return sd() if callable(sd) else None

    # ------------------------------------------------------------- cursor
    def state_dict(self) -> Dict:
        """The cursor of the last consumed batch: restoring it replays the
        stream from the first batch this consumer has not seen."""
        return {"consumed": self.consumed, "pipeline": self._cursor}

    def load_state_dict(self, st: Dict) -> None:
        if self._thread is not None:
            raise RuntimeError("load_state_dict after iteration started — the worker has "
                               "already advanced the pipeline past the cursor")
        self.consumed = int(st.get("consumed", 0))
        cur = st.get("pipeline")
        if cur is not None:
            if not hasattr(self.pipeline, "load_state_dict"):
                raise ValueError("cursor carries pipeline state but the wrapped "
                                 "pipeline has no load_state_dict")
            self.pipeline.load_state_dict(cur)
            self._cursor = cur

    # ------------------------------------------------------------- worker
    def _work(self) -> None:
        try:
            it = iter(self.pipeline)
            while not self._stop.is_set():
                try:
                    b = next(it)
                except StopIteration:
                    self._put(("end", None, None))
                    return
                if not self._put(("batch", b, self._snapshot())):
                    return      # stopped while blocked on a full queue
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            self._put(("error", e, None))

    def _put(self, item) -> bool:
        """A bounded put that still sees ``close()``."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_STOP_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _ensure_started(self) -> None:
        if self._closed:
            raise RuntimeError("producer is closed")
        if self._thread is None:
            self._thread = threading.Thread(target=self._work, name="batch-producer", daemon=True)
            self._thread.start()

    # ----------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._ended:
            raise StopIteration
        self._ensure_started()
        while True:
            try:
                kind, payload, cur = self._q.get(timeout=_STOP_POLL_S)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError("producer worker died without a terminal item") from None
        if kind == "end":
            self._ended = True
            raise StopIteration
        if kind == "error":
            raise payload
        if cur is not None:
            self._cursor = cur
        self.consumed += 1
        return payload

    # ----------------------------------------------------------- shutdown
    def close(self) -> None:
        """Stop the worker and drop the buffered batches.  Idempotent."""
        self._closed = True
        self._stop.set()
        t = self._thread
        if t is not None:
            try:        # drain, so a worker blocked on put() sees the stop
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "BackgroundProducer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
