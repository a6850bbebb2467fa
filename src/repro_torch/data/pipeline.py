"""The MLM batch pipeline of the ESM-2 recipe (the port's copy of the
reference's ``data/pipeline.py``; same draws for a seed).

Pure numpy on the host; each batch is a dict of int32 / float32 arrays
matching ``Model.loss_fn``'s contract, which the trainer copies to the
device.  The reference's bucketed path (a sampler with ``sample_batch``)
and CLM packing are not ported: the port has no such sampler yet.
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
    """ESM-2-style stream: cluster-sample -> pad to ``seq_len`` -> corrupt.
    Without a sampler, indices are drawn uniformly from the dataset."""

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
        while True:
            if self.sampler is not None:
                idx = self.sampler.sample(self.batch)
            else:
                idx = self.rng.integers(0, len(self.ds), size=self.batch)
            yield mlm_corrupt(self._pad(idx, self.seq_len), self.tok, self.rng, self.mask_prob)
