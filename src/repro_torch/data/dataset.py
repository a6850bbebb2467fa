"""Memory-mapped token datasets and a synthetic protein corpus (the port's
copy of the reference's ``data/dataset.py``; same file format, same draws).

``MemmapTokenDataset`` mirrors BioNeMo/Megatron's indexed binary datasets:
a flat ``.bin`` of int32 token ids plus an ``.idx`` of int64 offsets —
random access to any sequence without loading the corpus.
``synthetic_protein_sequences`` draws structured random sequences (motif
repetition, so small models have learnable signal) and
``synthetic_smiles_sequences`` SMILES strings from a few fragments, each
from numpy's ``default_rng`` in the reference's order, so one seed gives
the same corpus in both packages; ``build_synthetic_protein_store`` writes the same
sequences into a sharded store (``data/store.py``).
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.data.tokenizer import ProteinTokenizer


class MemmapTokenDataset:
    """Flat token store with an index; O(1) random sequence access."""

    MAGIC = 0x42494F4E  # "BION"

    def __init__(self, prefix: str):
        self.prefix = prefix
        idx = np.fromfile(prefix + ".idx", dtype=np.int64)
        if idx[0] != self.MAGIC:
            raise ValueError(f"{prefix}.idx: bad index file")
        n = int(idx[1])
        self.offsets = idx[2 : 2 + n + 1]
        self.tokens = np.memmap(prefix + ".bin", dtype=np.int32, mode="r")

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        a, b = int(self.offsets[i]), int(self.offsets[i + 1])
        return np.asarray(self.tokens[a:b])

    def lengths(self) -> np.ndarray:
        """Per-sequence token counts from the index alone."""
        return np.diff(self.offsets).astype(np.int64)

    @classmethod
    def write(cls, prefix: str, sequences: Sequence[np.ndarray]) -> "MemmapTokenDataset":
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        offsets = [0]
        with open(prefix + ".bin", "wb") as f:
            for s in sequences:
                np.asarray(s, np.int32).tofile(f)
                offsets.append(offsets[-1] + len(s))
        hdr = np.array([cls.MAGIC, len(sequences)] + offsets, dtype=np.int64)
        hdr.tofile(prefix + ".idx")
        return cls(prefix)


def synthetic_protein_sequences(
    n: int, min_len: int = 40, max_len: int = 200, seed: int = 0, n_motifs: int = 32
) -> List[str]:
    """Random AA sequences built from a shared motif library (learnable)."""
    rng = np.random.default_rng(seed)
    aas = ProteinTokenizer.AAS[:20]
    motifs = [
        "".join(rng.choice(list(aas), size=rng.integers(4, 9))) for _ in range(n_motifs)
    ]
    seqs = []
    for _ in range(n):
        L = int(rng.integers(min_len, max_len))
        parts = []
        while sum(map(len, parts)) < L:
            parts.append(motifs[int(rng.integers(n_motifs))])
        seqs.append("".join(parts)[:L])
    return seqs


def synthetic_smiles_sequences(n: int, seed: int = 0) -> List[str]:
    """``n`` SMILES strings, each 2-7 fragments drawn from a fixed list."""
    rng = np.random.default_rng(seed)
    frags = ["C", "CC", "C(=O)O", "c1ccccc1", "N", "O", "CN", "C(N)=O", "S", "F"]
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 8))
        out.append("".join(rng.choice(frags) for _ in range(k)))
    return out


def build_synthetic_protein_memmap(
    prefix: str, n: int = 2000, seed: int = 0, *, min_len: int = 40, max_len: int = 200,
) -> Tuple[MemmapTokenDataset, ProteinTokenizer]:
    """Encode ``synthetic_protein_sequences`` (with <cls>/<eos>) into a
    memmap dataset at ``prefix``.  The length range defaults to the
    reference's; ESM-2-sized runs pass their own."""
    tok = ProteinTokenizer()
    seqs = synthetic_protein_sequences(n, min_len=min_len, max_len=max_len, seed=seed)
    enc = [np.asarray(tok.encode(s), np.int32) for s in seqs]
    return MemmapTokenDataset.write(prefix, enc), tok


def build_synthetic_protein_store(
    root: str, n: int = 2000, seed: int = 0, shard_tokens: int = 1 << 16, *,
    min_len: int = 40, max_len: int = 200,
):
    """Sharded-store twin of :func:`build_synthetic_protein_memmap`: the
    same sequences for a given (n, seed), stored across shards."""
    from repro_torch.data.store import ShardedTokenStore

    tok = ProteinTokenizer()
    seqs = synthetic_protein_sequences(n, min_len=min_len, max_len=max_len, seed=seed)
    enc = [np.asarray(tok.encode(s), np.int32) for s in seqs]
    return ShardedTokenStore.write(root, enc, shard_tokens=shard_tokens), tok
