"""Node-id minibatches of a static size (counterpart of
``efficient_gnns_tpu/sampling/minibatch.py``).

Every batch has ``batch_size`` ids: the last one is padded with the first id
of the epoch's order and carries a validity mask, so every batch has the
same shapes. The order of an epoch is ``np.random.default_rng(seed)``'s
permutation, the same ids in the same batches as the JAX package.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class NodeBatcher:
    def __init__(self, node_ids: np.ndarray, batch_size: int, shuffle: bool = True):
        self.node_ids = np.asarray(node_ids)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle

    def __len__(self) -> int:
        return -(-len(self.node_ids) // self.batch_size)

    def epoch(self, seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields ``(ids int32[batch_size], mask bool[batch_size])``; the
        padding repeats the epoch's first id and is masked out."""
        ids = self.node_ids
        if self.shuffle:
            ids = np.random.default_rng(seed).permutation(ids)
        b = self.batch_size
        for i in range(0, len(ids), b):
            chunk = ids[i:i + b]
            mask = np.ones(b, dtype=bool)
            if len(chunk) < b:
                mask[len(chunk):] = False
                chunk = np.concatenate([chunk, np.full(b - len(chunk), ids[0], dtype=ids.dtype)])
            yield chunk.astype(np.int32), mask
