"""ESM-2 protein tokenizer (the port's own copy of the reference's).

Character-level over 5 specials + 25 amino-acid codes; ids are the same as
the reference's ``ProteinTokenizer``, so prompts encode identically in
both packages.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_SPECIALS = ["<pad>", "<cls>", "<eos>", "<unk>", "<mask>"]


class _CharTokenizer:
    def __init__(self, alphabet: Sequence[str]):
        self.vocab: List[str] = list(_SPECIALS) + list(alphabet)
        self.tok2id: Dict[str, int] = {t: i for i, t in enumerate(self.vocab)}
        self.pad_id = 0
        self.cls_id = 1
        self.eos_id = 2
        self.unk_id = 3
        self.mask_id = 4

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = [self.tok2id.get(c, self.unk_id) for c in text]
        if add_special:
            ids = [self.cls_id] + ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.vocab[i] for i in ids if i >= len(_SPECIALS))

    def encode_batch(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        out = np.full((len(texts), max_len), self.pad_id, np.int32)
        for r, t in enumerate(texts):
            ids = self.encode(t)[:max_len]
            out[r, : len(ids)] = ids
        return out


class ProteinTokenizer(_CharTokenizer):
    """ESM-2 amino-acid alphabet."""

    AAS = "LAGVSERTIDPKQNFYMHWCXBUZO"

    def __init__(self):
        super().__init__(self.AAS)
