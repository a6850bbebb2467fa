"""The batch pipelines (the port's copy of the reference's
``data/pipeline.py``; same draws for a seed): the MLM stream of the ESM-2
recipe and the packed causal-LM stream of a causal model.

Pure numpy on the host; each batch is a dict of int32 / float32 arrays
matching ``Model.loss_fn``'s contract, which the trainer copies to the
device.  Both streams take a batch sampler duck-typed on
``sample_batch() -> (indices, padded_len)`` (``SizeAwareSampler``), as in
the reference: variable rows, bucketed lengths, a token budget.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data.dataset import MemmapTokenDataset
from repro_torch.data.sampler import ClusterSampler
from repro_torch.data.tokenizer import _CharTokenizer


def mlm_corrupt(
    tokens: np.ndarray,       # (B, S) int32, padded
    tokenizer: _CharTokenizer,
    rng: np.random.Generator,
    mask_prob: float = 0.15,
) -> Dict[str, np.ndarray]:
    """BERT/ESM-2 corruption: of the selected positions 80% <mask>, 10%
    random, 10% kept; loss only on selected positions."""
    B, S = tokens.shape
    special = tokens < 5
    pick = (rng.random((B, S)) < mask_prob) & ~special
    # guarantee >= 1 target per row (avoids empty-loss rows)
    none = ~pick.any(axis=1)
    if none.any():
        first_real = np.argmax(~special, axis=1)
        pick[np.where(none)[0], first_real[none]] = ~special[np.where(none)[0], first_real[none]]
    r = rng.random((B, S))
    corrupted = tokens.copy()
    corrupted[pick & (r < 0.8)] = tokenizer.mask_id
    rand_ids = rng.integers(5, tokenizer.vocab_size, size=(B, S))
    sel_rand = pick & (r >= 0.8) & (r < 0.9)
    corrupted[sel_rand] = rand_ids[sel_rand]
    return {
        "tokens": corrupted.astype(np.int32),
        "targets": tokens.astype(np.int32),
        "loss_mask": pick.astype(np.float32),
    }


class MLMBatches:
    """ESM-2-style stream: cluster-sample -> pad -> corrupt.

    ``sampler`` may be an index sampler (``ClusterSampler``: fixed
    ``(batch, seq_len)`` shapes) or a batch sampler with ``sample_batch()
    -> (indices, padded_len)`` (``SizeAwareSampler``: variable rows,
    bucketed lengths at most ``seq_len``, the token budget kept).  Without
    a sampler, indices are drawn uniformly from the dataset."""

    def __init__(
        self,
        ds: MemmapTokenDataset,
        tokenizer: _CharTokenizer,
        sampler: Optional[ClusterSampler],
        batch: int,
        seq_len: int,
        mask_prob: float = 0.15,
        seed: int = 0,
    ):
        self.ds, self.tok, self.sampler = ds, tokenizer, sampler
        self.batch, self.seq_len, self.mask_prob = batch, seq_len, mask_prob
        self.rng = np.random.default_rng(seed)

    def state_dict(self) -> Dict:
        """Resumable cursor (JSON-serializable): the numpy Generator state
        and the sampler's, so a resumed run draws the batches the
        interrupted run would have."""
        st: Dict = {"rng": self.rng.bit_generator.state}
        if self.sampler is not None:
            st["sampler"] = self.sampler.state_dict()
        return st

    def load_state_dict(self, st: Dict) -> None:
        self.rng.bit_generator.state = st["rng"]
        if self.sampler is not None and "sampler" in st:
            self.sampler.load_state_dict(st["sampler"])

    def _pad(self, idx: np.ndarray, L: int) -> np.ndarray:
        seqs = [self.ds[int(i)][:L] for i in idx]
        lens = np.fromiter((len(s) for s in seqs), np.int64, count=len(seqs))
        toks = np.zeros((len(seqs), L), np.int32)
        toks[np.arange(L)[None, :] < lens[:, None]] = np.concatenate(seqs)
        return toks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.sampler is not None and hasattr(self.sampler, "sample_batch"):
            while True:   # bucketed: the sampler owns the rows and the length
                idx, L = self.sampler.sample_batch()
                toks = self._pad(idx, min(int(L), self.seq_len))
                yield mlm_corrupt(toks, self.tok, self.rng, self.mask_prob)
        while True:
            if self.sampler is not None:
                idx = self.sampler.sample(self.batch)
            else:
                idx = self.rng.integers(0, len(self.ds), size=self.batch)
            yield mlm_corrupt(self._pad(idx, self.seq_len), self.tok, self.rng, self.mask_prob)


class CLMBatches:
    """Packed causal-LM stream: documents drawn uniformly, concatenated and
    cut into ``batch`` windows of ``seq_len``.

    ``eos_id`` (when set) goes between packed documents, so that the causal
    model sees each document boundary.  ``sampler`` (duck-typed on
    ``sample_batch() -> (indices, length)``) switches to a bucketed
    per-document mode: batches of the sampler's rows padded to its length
    (at most ``seq_len``), with a ``loss_mask`` zeroing the padding."""

    def __init__(self, ds: MemmapTokenDataset, batch: int, seq_len: int, seed: int = 0,
                 eos_id: Optional[int] = None, sampler=None):
        self.ds, self.batch, self.seq_len = ds, batch, seq_len
        self.eos_id = eos_id
        self.sampler = sampler
        self.rng = np.random.default_rng(seed)
        self._buf = np.empty((0,), np.int32)

    def state_dict(self) -> Dict:
        """Resumable cursor (JSON-serializable): the Generator state and the
        packing carry, the tokens drawn but not yet emitted."""
        st: Dict = {"rng": self.rng.bit_generator.state,
                    "buf": np.asarray(self._buf, np.int32).tolist()}
        if self.sampler is not None:
            st["sampler"] = self.sampler.state_dict()
        return st

    def load_state_dict(self, st: Dict) -> None:
        self.rng.bit_generator.state = st["rng"]
        self._buf = np.asarray(st["buf"], np.int32)
        if self.sampler is not None and "sampler" in st:
            self.sampler.load_state_dict(st["sampler"])

    def _fill(self, need: int) -> None:
        # the separator draws nothing from the RNG, so cursors taken with and
        # without eos_id replay the same documents in the same order
        chunks, have = [self._buf], len(self._buf)
        sep = None if self.eos_id is None else np.asarray([self.eos_id], np.int32)
        while have < need:
            s = self.ds[int(self.rng.integers(len(self.ds)))]
            chunks.append(s)
            have += len(s)
            if sep is not None:
                chunks.append(sep)
                have += 1
        self._buf = np.concatenate(chunks)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.sampler is not None and hasattr(self.sampler, "sample_batch"):
            while True:   # bucketed per-document mode: no packing
                idx, L = self.sampler.sample_batch()
                L = min(int(L), self.seq_len)
                seqs = [self.ds[int(i)][:L] for i in idx]
                lens = np.fromiter((len(s) for s in seqs), np.int64, count=len(seqs))
                real = np.arange(L)[None, :] < lens[:, None]
                toks = np.zeros((len(seqs), L), np.int32)
                toks[real] = np.concatenate(seqs)
                yield {"tokens": toks, "loss_mask": real.astype(np.float32)}
        need = self.batch * self.seq_len
        while True:
            self._fill(need)
            flat, self._buf = self._buf[:need], self._buf[need:]
            yield {"tokens": flat.reshape(self.batch, self.seq_len).astype(np.int32)}
