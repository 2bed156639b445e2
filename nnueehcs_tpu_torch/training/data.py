"""Array-first data loading.

Counterpart of ``nnueehcs_tpu/training/data.py``. :class:`DataLoader` keeps
the reference's knobs (``batch_size``, ``shuffle``, ``drop_last``) but hands
the whole arrays and the batching plan to the trainer, which moves them to
the device once and slices batches there by an index permutation.
"""
from __future__ import annotations

import numpy as np


class ArrayDataset:
    """(inputs, outputs) pair, in place of torch's ``TensorDataset``."""

    def __init__(self, inputs, outputs):
        self.input = np.asarray(inputs)
        self.output = np.asarray(outputs)
        if len(self.input) != len(self.output):
            raise ValueError(f'{len(self.input)} inputs but '
                             f'{len(self.output)} outputs')

    def __len__(self):
        return len(self.input)

    def __getitem__(self, idx):
        return self.input[idx], self.output[idx]


def _extract_arrays(dataset):
    if hasattr(dataset, 'input') and hasattr(dataset, 'output'):
        return np.asarray(dataset.input), np.asarray(dataset.output)
    # a generic indexable of (x, y) pairs
    xs, ys = zip(*[dataset[i] for i in range(len(dataset))])
    return np.stack(xs), np.stack(ys)


class DataLoader:
    def __init__(self, dataset, batch_size: int = 32, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.inputs, self.outputs = _extract_arrays(dataset)

    def __len__(self):
        n = len(self.inputs)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def num_samples(self):
        return len(self.inputs)

    def __iter__(self):
        """Host-side iteration (for hooks and inspection, not the trainer)."""
        n = len(self.inputs)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed).permutation(n)
        for b in range(len(self)):
            sl = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.inputs[sl], self.outputs[sl]
