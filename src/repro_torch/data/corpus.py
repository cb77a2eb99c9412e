"""Walk corpus -> LM training batches.

This is the integration point between the paper's system and the assigned
LM architectures (DESIGN.md §4): DeepWalk/Node2vec walks ARE token
sequences over the vertex vocabulary.  The pipeline packs walk sequences
into fixed-length LM examples (BOS-separated, label-shifted) and also emits
skip-gram pairs for classical embedding training.

Determinism & fault tolerance: the corpus is addressed by a monotone cursor
(walk index); the cursor is part of the checkpoint manifest, so a restarted
job resumes mid-epoch on the exact same batch order (runtime/fault.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["WalkCorpus", "skipgram_pairs"]

BOS_OFFSET = 1  # token 0 = BOS/separator; vertex v -> token v + 1


@dataclasses.dataclass
class WalkCorpus:
    """walks: [N, L+1] int32 with -1 padding after early termination."""

    walks: np.ndarray
    vocab_size: int  # num_vertices + BOS_OFFSET

    @classmethod
    def from_walks(cls, walks: np.ndarray, num_vertices: int) -> "WalkCorpus":
        return cls(np.asarray(walks, np.int32), num_vertices + BOS_OFFSET)

    def __len__(self) -> int:
        return int(self.walks.shape[0])

    def token_stream(self, cursor: int = 0) -> Iterator[np.ndarray]:
        """Yield per-walk token arrays: [BOS, v0+1, v1+1, ...]."""
        n = len(self)
        for i in range(cursor, n):
            w = self.walks[i]
            w = w[w >= 0]
            yield np.concatenate([[0], w.astype(np.int64) + BOS_OFFSET])

    def batches(
        self,
        batch_size: int,
        seq_len: int,
        *,
        cursor: int = 0,
        epochs: Optional[int] = None,
        seed: int = 0,
    ) -> Iterator[dict]:
        """Packed LM batches: {tokens [B,S], labels [B,S], cursor}.

        Walks are concatenated (BOS-separated) then chunked; labels are the
        next-token shift.  Each batch starts fresh at its walk cursor and
        the partial-walk remainder is DISCARDED at the batch boundary —
        batches are therefore a pure function of (seed, cursor), which is
        what makes crash->restart resume bitwise exact (runtime/fault.py);
        the cost is < 1 walk of tokens per batch.
        """
        need = batch_size * (seq_len + 1)
        epoch = 0
        i = cursor
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))
        while epochs is None or epoch < epochs:
            buf = np.zeros(0, np.int64)
            while i < len(self) and buf.shape[0] < need:
                w = self.walks[order[i]]
                w = w[w >= 0].astype(np.int64) + BOS_OFFSET
                buf = np.concatenate([buf, [0], w])
                i += 1
            if buf.shape[0] >= need:
                chunk = buf[:need].reshape(batch_size, seq_len + 1)
                yield {
                    "tokens": chunk[:, :-1].astype(np.int32),
                    "labels": chunk[:, 1:].astype(np.int32),
                    "cursor": i,
                    "epoch": epoch,
                }
            if i >= len(self):
                i = 0
                order = rng.permutation(len(self))
                epoch += 1


def skipgram_pairs(
    walks: np.ndarray, window: int = 5, *, max_pairs: Optional[int] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(center, context) pairs for word2vec-style embedding training —
    exactly how Node2vec consumes its walks."""
    rng = np.random.default_rng(seed)
    centers, contexts = [], []
    for row in walks:
        row = row[row >= 0]
        L = row.shape[0]
        for i in range(L):
            w = rng.integers(1, window + 1)
            lo, hi = max(0, i - w), min(L, i + w + 1)
            for j in range(lo, hi):
                if j != i:
                    centers.append(row[i])
                    contexts.append(row[j])
        if max_pairs and len(centers) >= max_pairs:
            break
    c = np.asarray(centers[:max_pairs], np.int32)
    x = np.asarray(contexts[:max_pairs], np.int32)
    return c, x
