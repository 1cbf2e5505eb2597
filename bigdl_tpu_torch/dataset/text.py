"""PTB-style text helpers (counterpart of bigdl_tpu/dataset/text.py:52-104,
154-177): the vocabulary, the one-sentence-per-line reader and the
contiguous-stream LM batching.  Host-side numpy only; the device sees
fixed-shape integer arrays."""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class Dictionary:
    """token <-> index vocabulary with UNK handling (reference
    Dictionary.scala): index 0 is the padding token, 1 is UNK, then the
    most common tokens, capped at ``vocab_size`` entries in all; the
    discarded tail maps to UNK."""

    def __init__(self, sentences: Optional[Iterator[Sequence[str]]] = None,
                 vocab_size: Optional[int] = None,
                 unk: str = "<unk>", padding: str = "<pad>"):
        self.unk, self.padding = unk, padding
        self.word2idx: Dict[str, int] = {padding: 0, unk: 1}
        self.idx2word: List[str] = [padding, unk]
        if sentences is not None:
            counts = Counter()
            for toks in sentences:
                counts.update(toks)
            counts.pop(padding, None)
            counts.pop(unk, None)
            keep = counts.most_common(
                None if vocab_size is None else max(vocab_size - 2, 0))
            for w, _ in keep:
                self.word2idx[w] = len(self.idx2word)
                self.idx2word.append(w)

    @property
    def vocab_size(self) -> int:
        return len(self.idx2word)

    def get_index(self, word: str) -> int:
        return self.word2idx.get(word, self.word2idx[self.unk])

    def get_word(self, index: int) -> str:
        return self.idx2word[index]

    def to_indices(self, tokens: Sequence[str]) -> np.ndarray:
        return np.asarray([self.get_index(t) for t in tokens], np.int32)


def read_sentences(path: str) -> List[str]:
    """One sentence per line, blank lines dropped (the PTB layout)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def ptb_batchify(token_ids: np.ndarray, batch_size: int, num_steps: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous-stream LM batching: the corpus as ``batch_size``
    parallel streams cut into ``num_steps`` windows; returns (inputs,
    targets) of shape (n_windows, batch_size, num_steps), the targets
    shifted by one token."""
    ids = np.asarray(token_ids)
    stream_len = len(ids) // batch_size
    streams = ids[: stream_len * batch_size].reshape(batch_size, stream_len)
    n_windows = (stream_len - 1) // num_steps
    xs, ys = [], []
    for i in range(n_windows):
        s = i * num_steps
        xs.append(streams[:, s: s + num_steps])
        ys.append(streams[:, s + 1: s + num_steps + 1])
    return np.stack(xs), np.stack(ys)
