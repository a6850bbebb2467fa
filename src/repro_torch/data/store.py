"""Sharded memmap token store (the port's copy of the reference's
``data/store.py``; the same on-disk format, so either package reads the
other's stores).

Layout on disk — one directory per store:

    store/
      manifest.json          # committed LAST, os.replace-atomic
      shard_00000.bin        # flat little-endian token ids (dtype below)
      shard_00000.idx.npy    # int64 offsets, len = n_seqs + 1
      shard_00001.bin
      ...

``manifest.json`` (version 1)::

    {"version": 1, "dtype": "int32",
     "total_sequences": N, "total_tokens": T,
     "shards": [{"bin": "shard_00000.bin", "index": "shard_00000.idx.npy",
                 "sequences": n0, "tokens": t0}, ...]}

* **Zero-copy reads** — each shard's ``.bin`` is an ``np.memmap``, mapped
  on first touch; ``__getitem__`` returns a view into the mapping.
* **Atomic commit** — the writer stages the shard files and writes the
  manifest last (tmp + ``os.replace``): a crash mid-write leaves no
  manifest, never one pointing at truncated shards.
* **Global index** — sequence ``i`` resolves to ``(shard, local)`` through
  a cumulative-count ``searchsorted``.
* **Worker sharding** — ``reader(worker=w, num_workers=W)`` iterates the
  shards assigned round-robin to worker ``w``, with a resumable
  ``state_dict`` cursor (assigned-shard position + local index).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

MANIFEST = "manifest.json"
STORE_VERSION = 1


def _shard_names(i: int) -> tuple:
    return f"shard_{i:05d}.bin", f"shard_{i:05d}.idx.npy"


class ShardedStoreWriter:
    """Streaming writer: ``add()`` sequences, shards flush at a token
    threshold, ``finalize()`` commits the manifest atomically.  As a context
    manager, a clean exit finalizes::

        with ShardedStoreWriter(root, shard_tokens=1 << 20) as w:
            for seq in corpus:
                w.add(seq)
    """

    def __init__(self, root: str, *, shard_tokens: int = 1 << 22, dtype: str = "int32"):
        if shard_tokens < 1:
            raise ValueError(f"shard_tokens must be >= 1 (got {shard_tokens})")
        self.root = root
        self.shard_tokens = int(shard_tokens)
        self.dtype = np.dtype(dtype)
        os.makedirs(root, exist_ok=True)
        self.shards: List[Dict] = []
        self._buf: List[np.ndarray] = []     # pending sequences
        self._buf_tokens = 0
        self.total_sequences = 0
        self.total_tokens = 0
        self._finalized = False

    def add(self, seq: Sequence[int]) -> int:
        """Append one sequence; returns its global index.  The current shard
        flushes once it holds >= ``shard_tokens`` tokens."""
        if self._finalized:
            raise RuntimeError("writer already finalized")
        a = np.ascontiguousarray(np.asarray(seq, self.dtype))
        if a.ndim != 1 or len(a) == 0:
            raise ValueError(f"sequences must be non-empty 1-D (got {a.shape})")
        i = self.total_sequences
        self._buf.append(a)
        self._buf_tokens += len(a)
        self.total_sequences += 1
        self.total_tokens += len(a)
        if self._buf_tokens >= self.shard_tokens:
            self._flush_shard()
        return i

    def _flush_shard(self) -> None:
        if not self._buf:
            return
        bin_name, idx_name = _shard_names(len(self.shards))
        offsets = np.zeros((len(self._buf) + 1,), np.int64)
        with open(os.path.join(self.root, bin_name), "wb") as f:
            for j, s in enumerate(self._buf):
                s.tofile(f)
                offsets[j + 1] = offsets[j] + len(s)
        np.save(os.path.join(self.root, idx_name), offsets)
        self.shards.append({"bin": bin_name, "index": idx_name,
                            "sequences": len(self._buf), "tokens": int(offsets[-1])})
        self._buf = []
        self._buf_tokens = 0

    def finalize(self) -> "ShardedTokenStore":
        """Flush the tail shard and commit the manifest (tmp + ``os.replace``:
        the store becomes visible atomically)."""
        if self._finalized:
            raise RuntimeError("writer already finalized")
        self._flush_shard()
        if not self.shards:
            raise ValueError("cannot finalize an empty store")
        manifest = {"version": STORE_VERSION, "dtype": self.dtype.name,
                    "total_sequences": self.total_sequences, "total_tokens": self.total_tokens,
                    "shards": self.shards}
        path = os.path.join(self.root, MANIFEST)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
        self._finalized = True
        return ShardedTokenStore(self.root)

    def __enter__(self) -> "ShardedStoreWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and not self._finalized:
            self.finalize()


class ShardedTokenStore:
    """Multi-shard memmap token store; O(1) zero-copy random access.

    It has the ``MemmapTokenDataset`` surface the pipelines use
    (``__len__`` / ``__getitem__`` / ``lengths()``), so ``MLMBatches``,
    ``CLMBatches`` and ``SizeAwareSampler`` feed from it unchanged."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, MANIFEST)
        with open(path) as f:
            m = json.load(f)
        if m.get("version") != STORE_VERSION:
            raise ValueError(f"{path}: unsupported store version {m.get('version')!r} "
                             f"(want {STORE_VERSION})")
        self.manifest = m
        self.dtype = np.dtype(m["dtype"])
        self.shards = m["shards"]
        counts = np.asarray([s["sequences"] for s in self.shards], np.int64)
        self.cum_seqs = np.concatenate([[0], np.cumsum(counts)])   # first index of each shard
        self.total_tokens = int(m["total_tokens"])
        # mapped lazily: opening a store must not map every shard
        self._tokens: List[Optional[np.memmap]] = [None] * len(self.shards)
        self._offsets: List[Optional[np.ndarray]] = [None] * len(self.shards)

    # ------------------------------------------------------------- access
    def __len__(self) -> int:
        return int(self.cum_seqs[-1])

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def _shard_tokens(self, k: int) -> np.memmap:
        if self._tokens[k] is None:
            self._tokens[k] = np.memmap(os.path.join(self.root, self.shards[k]["bin"]),
                                        dtype=self.dtype, mode="r")
        return self._tokens[k]

    def _shard_offsets(self, k: int) -> np.ndarray:
        if self._offsets[k] is None:
            self._offsets[k] = np.load(os.path.join(self.root, self.shards[k]["index"]))
        return self._offsets[k]

    def locate(self, i: int) -> tuple:
        """Global index -> (shard, local) through the cumulative count table."""
        n = len(self)
        if not 0 <= i < n:
            raise IndexError(f"sequence {i} out of range [0, {n})")
        k = int(np.searchsorted(self.cum_seqs, i, side="right")) - 1
        return k, i - int(self.cum_seqs[k])

    def __getitem__(self, i: int) -> np.ndarray:
        k, j = self.locate(int(i))
        off = self._shard_offsets(k)
        return np.asarray(self._shard_tokens(k)[int(off[j]):int(off[j + 1])])

    def lengths(self) -> np.ndarray:
        """Per-sequence token counts of every sequence, from the shards'
        offset tables alone (no token bytes read)."""
        return np.concatenate([np.diff(self._shard_offsets(k))
                               for k in range(self.num_shards)]).astype(np.int64)

    # ------------------------------------------------------------ readers
    def shard_assignment(self, worker: int, num_workers: int) -> List[int]:
        """Round-robin shard ownership: worker ``w`` of ``W`` owns shards
        ``w, w+W, w+2W, ...`` — disjoint, and adding workers never reorders
        a worker's own shards."""
        if not 0 <= worker < num_workers:
            raise ValueError(f"worker {worker} not in [0, {num_workers})")
        return list(range(worker, self.num_shards, num_workers))

    def reader(self, *, worker: int = 0, num_workers: int = 1) -> "ShardReader":
        return ShardReader(self, self.shard_assignment(worker, num_workers))

    # ------------------------------------------------------------ writing
    @classmethod
    def write(cls, root: str, sequences: Sequence[np.ndarray], *,
              shard_tokens: int = 1 << 22, dtype: str = "int32") -> "ShardedTokenStore":
        with ShardedStoreWriter(root, shard_tokens=shard_tokens, dtype=dtype) as w:
            for s in sequences:
                w.add(s)
        return cls(root)


class ShardReader:
    """Sequential reader over assigned shards, one epoch, with a resumable
    cursor ``(assigned-shard position, local sequence index)``: restoring it
    mid-epoch replays the remaining sequences exactly."""

    def __init__(self, store: ShardedTokenStore, shard_ids: List[int]):
        self.store = store
        self.shard_ids = list(shard_ids)
        self._pos = 0       # position in the assigned shard list
        self._local = 0     # next sequence within the current shard

    def state_dict(self) -> Dict:
        return {"pos": self._pos, "local": self._local}

    def load_state_dict(self, st: Dict) -> None:
        self._pos = int(st["pos"])
        self._local = int(st["local"])

    def __len__(self) -> int:
        return sum(self.store.shards[k]["sequences"] for k in self.shard_ids)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        while self._pos < len(self.shard_ids):
            k = self.shard_ids[self._pos]
            if self._local < self.store.shards[k]["sequences"]:
                g = int(self.store.cum_seqs[k]) + self._local
                self._local += 1
                return self.store[g]
            self._pos += 1
            self._local = 0
        raise StopIteration
