"""Token-budget batching (the port's copy of the reference's
``data/size_aware.py``; the same draws, bit for bit, for a seed, and the
same cursor, so a cursor saved by either package restores in the other).

Fixed-batch padding on a length-skewed protein corpus wastes most of the
token budget: a 100-residue sequence in a batch padded to 1024 pays for
1024 tokens of compute.  ``SizeAwareSampler`` replaces the fixed batch
size with a token budget: sequences are bucketed by length, and a bucket
emits a batch of as many rows as fit under ``max_tokens`` at its padded
length — short sequences travel in wide batches, long ones in narrow ones.

* The draw stream is a function of the base sampler's state (a composed
  ``ClusterSampler``) or of this sampler's own numpy Generator.
* Draws accumulate in per-bucket pending lists; a bucket that reaches its
  row capacity emits a batch.
* ``state_dict`` holds the draw state and the pending and ready queues, so
  ``load_state_dict`` resumes the exact batch sequence mid-epoch.

Every batch is padded to its bucket's upper bound, so a corpus yields at
most ``len(boundaries)`` distinct ``(rows, len)`` shapes.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def length_buckets(max_len: int, *, min_len: int = 16, growth: float = 1.3) -> np.ndarray:
    """Geometric bucket upper bounds ``[min_len, ..., max_len]``.

    Consecutive bounds grow by ``growth``, which caps a row's padding inside
    a bucket at about ``1 - 1/growth`` (~23% at the default)."""
    if not (max_len >= min_len >= 1):
        raise ValueError(f"need max_len >= min_len >= 1, got ({max_len}, {min_len})")
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1 (got {growth})")
    bounds = [min_len]
    while bounds[-1] < max_len:
        bounds.append(min(int(np.ceil(bounds[-1] * growth)), max_len))
    return np.asarray(bounds, np.int64)


class SizeAwareSampler:
    """Variable-size, budget-bounded batch sampler over known lengths.

    ``lengths``: per-sequence token counts, clipped to the pipeline's
    ``seq_len`` before construction.  ``max_tokens``: every batch has
    ``rows * padded_len <= max_tokens``.  ``base``: an optional composed
    index sampler (``ClusterSampler``) that owns the draw stream; without
    it, indices are drawn uniformly from ``seed``.  ``boundaries``: explicit
    bucket upper bounds (default: ``length_buckets`` up to the longest).
    ``round_to``: row capacities round down to a multiple of it.
    ``draw_chunk``: draws taken from the stream at a time."""

    def __init__(self, lengths: Sequence[int], max_tokens: int, *, base=None,
                 boundaries: Optional[Sequence[int]] = None, seed: int = 0, min_len: int = 16,
                 growth: float = 1.3, round_to: int = 1, draw_chunk: int = 64):
        self.lengths = np.asarray(lengths, np.int64)
        if len(self.lengths) == 0:
            raise ValueError("empty corpus")
        self.max_tokens = int(max_tokens)
        self.base = base
        self.rng = np.random.default_rng(seed)
        self.round_to = max(int(round_to), 1)
        self.draw_chunk = max(int(draw_chunk), 1)
        lmax = int(self.lengths.max())
        if boundaries is None:
            self.boundaries = length_buckets(lmax, min_len=min(min_len, lmax), growth=growth)
        else:
            self.boundaries = np.asarray(sorted(boundaries), np.int64)
            if lmax > self.boundaries[-1]:
                raise ValueError(f"longest sequence ({lmax}) exceeds the top bucket "
                                 f"boundary ({self.boundaries[-1]})")
        # rows under the budget at each bucket's padded length, rounded down
        # to round_to; a budget that fits no (rounded) row of a bucket is
        # refused up front
        caps = self.max_tokens // self.boundaries
        caps = (caps // self.round_to) * self.round_to
        if (caps < 1).any():
            b = int(self.boundaries[(caps < 1).argmax()])
            raise ValueError(f"max_tokens={self.max_tokens} cannot fit "
                             f"{self.round_to} row(s) of bucket len {b}")
        self.capacity = caps.astype(np.int64)
        # each sequence's bucket: the first boundary >= its length
        self.bucket_of = np.searchsorted(self.boundaries, self.lengths, side="left").astype(np.int64)
        self._pending: List[List[int]] = [[] for _ in range(len(self.boundaries))]
        self._ready: collections.deque = collections.deque()

    # -------------------------------------------------------------- cursor
    def state_dict(self) -> Dict:
        """JSON-serializable cursor: the draw state and the queues."""
        st: Dict = {
            "pending": [list(map(int, p)) for p in self._pending],
            "ready": [(list(map(int, idx)), int(L)) for idx, L in self._ready],
        }
        if self.base is not None:
            st["base"] = self.base.state_dict()
        else:
            st["rng"] = self.rng.bit_generator.state
        return st

    def load_state_dict(self, st: Dict) -> None:
        self._pending = [list(p) for p in st["pending"]]
        if len(self._pending) != len(self.boundaries):
            raise ValueError(f"cursor has {len(self._pending)} buckets, sampler has "
                             f"{len(self.boundaries)} — bucket config changed?")
        self._ready = collections.deque((np.asarray(idx, np.int64), int(L))
                                        for idx, L in st["ready"])
        if self.base is not None:
            self.base.load_state_dict(st["base"])
        else:
            self.rng.bit_generator.state = st["rng"]

    # ------------------------------------------------------------ sampling
    def _draw(self, n: int) -> np.ndarray:
        if self.base is not None:
            return np.asarray(self.base.sample(n), np.int64)
        return self.rng.integers(0, len(self.lengths), size=n)

    def sample_batch(self) -> Tuple[np.ndarray, int]:
        """The next ``(indices, padded_len)`` batch under the budget.  Draws
        are taken in chunks and processed in order, so the batches are a
        function of the cursor."""
        while not self._ready:
            for i in self._draw(self.draw_chunk):
                b = int(self.bucket_of[i])
                pend = self._pending[b]
                pend.append(int(i))
                if len(pend) == int(self.capacity[b]):
                    self._ready.append((np.asarray(pend, np.int64), int(self.boundaries[b])))
                    self._pending[b] = []
        return self._ready.popleft()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        while True:
            yield self.sample_batch()
