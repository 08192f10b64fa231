"""Fixed-shape numpy batching, a copy of
``item_alignment_tpu/data/datasets.py:ArrayDataset``.

Tokenized data arrives as fixed-shape arrays; the loader is a thin shuffling
batcher (``np.random.RandomState(seed)``, as the JAX package shuffles) that
pads the last batch to a full batch by repeating its last row and reports
``n_valid``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class ArrayDataset:
    """A dict of equal-length numpy arrays + optional per-row metadata
    (e.g. item-id strings) that never touches the device."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 meta: Optional[Dict[str, Sequence]] = None):
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged arrays: {lens}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.meta = meta or {}
        for k, v in self.meta.items():
            if len(v) != len(self):
                raise ValueError(f"meta {k} length mismatch")

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}

    def select(self, indices: np.ndarray) -> "ArrayDataset":
        meta = {k: [v[i] for i in indices] for k, v in self.meta.items()}
        return ArrayDataset({k: v[indices] for k, v in self.arrays.items()}, meta)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
    ) -> Iterator[Tuple[Dict[str, np.ndarray], Dict]]:
        """Yields (batch arrays padded to batch_size, meta dict with
        ``n_valid`` and any per-row metadata lists)."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            n_valid = len(idx)
            if n_valid < batch_size:
                if drop_last:
                    return
                pad = np.concatenate([idx, np.repeat(idx[-1:], batch_size - n_valid)])
                idx = pad
            batch = {k: v[idx] for k, v in self.arrays.items()}
            meta = {"n_valid": n_valid}
            for k, v in self.meta.items():
                meta[k] = [v[i] for i in idx[:n_valid]]
            yield batch, meta

    def num_batches(self, batch_size: int, drop_last: bool = False) -> int:
        n = len(self)
        return n // batch_size if drop_last else -(-n // batch_size)
