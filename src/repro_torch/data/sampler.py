"""UniRef50/90-style cluster sampling (the port's copy of the reference's
``data/sampler.py``; draws are bit-stream-exact with it for a seed).

ESM-2 training samples a UniRef50 *cluster* uniformly, then a UniRef90
*member* of that cluster uniformly, down-weighting over-represented
families.  ``ClusterSampler`` reproduces that two-level scheme over any
membership table.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


class ClusterSampler:
    def __init__(self, cluster_members: Sequence[Sequence[int]], seed: int = 0):
        """cluster_members[c] = dataset indices belonging to cluster c."""
        self.members = [np.asarray(m, np.int64) for m in cluster_members]
        if not all(len(m) > 0 for m in self.members):
            raise ValueError("empty cluster")
        self.rng = np.random.default_rng(seed)
        # flat member table: cluster c occupies _flat[_off[c] : _off[c] + _sizes[c]]
        self._sizes = np.asarray([len(m) for m in self.members], np.int64)
        self._off = np.concatenate([[0], np.cumsum(self._sizes[:-1])])
        self._flat = np.concatenate(self.members)

    def state_dict(self) -> Dict:
        """Resumable cursor (JSON-serializable Generator state)."""
        return {"rng": self.rng.bit_generator.state}

    def load_state_dict(self, st: Dict) -> None:
        self.rng.bit_generator.state = st["rng"]

    def sample(self, n: int) -> np.ndarray:
        cl = self.rng.integers(0, len(self.members), size=n)
        # the broadcast high array consumes the bit stream as per-item
        # scalar draws would, as in the reference
        k = self.rng.integers(0, self._sizes[cl])
        return self._flat[self._off[cl] + k]

    def __iter__(self) -> Iterator[int]:
        while True:
            yield int(self.sample(1)[0])


def greedy_length_clusters(lengths: Sequence[int], n_clusters: int) -> List[List[int]]:
    """Toy clustering by length rank — stands in for MMseqs2 clustering
    when building synthetic corpora."""
    order = np.argsort(lengths)
    buckets: List[List[int]] = [[] for _ in range(n_clusters)]
    for rank, idx in enumerate(order):
        buckets[rank % n_clusters].append(int(idx))
    return buckets
