"""Epoch order and batching of the training data (port of
tcvom_tpu/data/loader.py on ``torch.utils.data``).

:func:`epoch_indices` is the JAX package's deterministic per-epoch
shuffle, padded by wrapping to whole batches (DistributedSampler
semantics on one shard). :class:`EpochSampler` yields the keys
``(epoch, idx)``, and the datasets draw an item's randomness from
``(seed, epoch, idx)`` alone: an item is the same whichever process
reads it, and a new epoch reaches worker processes started in an earlier
one (a ``set_epoch`` on the main process's dataset would not).
"""
from __future__ import annotations

import numpy as np
import torch.utils.data


def epoch_indices(n: int, epoch: int, shuffle: bool, seed: int = 0,
                  drop_last: bool = True, block: int = 1) -> np.ndarray:
    """The sample order of ``epoch``: a permutation from ``seed + epoch``
    (or 0..n-1), wrapped up to a whole number of ``block``s when
    ``drop_last`` (tcvom_tpu/data/loader.py:19-52 on one shard)."""
    idx = np.arange(n)
    if shuffle:
        idx = np.random.RandomState(seed + epoch).permutation(n)
    if drop_last and n % block:
        total = -(-n // block) * block
        idx = np.tile(idx, -(-total // n))[:total]
    return idx


class EpochSampler(torch.utils.data.Sampler):
    """The keys ``(epoch, idx)`` of the epoch set by :meth:`set_epoch`, in
    :func:`epoch_indices`' order for batches of ``batch_size``."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.n, self.batch_size, self.shuffle = n, batch_size, shuffle
        self.seed, self.drop_last = seed, drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        return epoch_indices(self.n, self.epoch, self.shuffle, self.seed,
                             drop_last=self.drop_last, block=self.batch_size)

    def __iter__(self):
        return iter([(self.epoch, int(i)) for i in self._indices()])

    def __len__(self) -> int:
        return len(self._indices())


def stack_collate(items: list[dict]) -> dict:
    """Stack each key's numpy arrays along a new batch axis."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def make_loader(dataset, batch_size: int, num_workers: int = 0,
                shuffle: bool = False, seed: int = 0,
                drop_last: bool = False) -> torch.utils.data.DataLoader:
    """Batches of numpy arrays in :class:`EpochSampler`'s order, the JAX
    package's ``DataLoader``: by default in order with a short last batch
    (the evaluation sweeps'), or shuffled and wrapped to whole batches
    (``shuffle=True, drop_last=True``, the trainer's). ``set_epoch`` is
    the sampler's: ``loader.sampler.set_epoch``. Worker processes are
    spawned, not forked (the caller has CUDA's threads and the intra-op
    pool), and kept across epochs; each imports torch and this package
    before its first item."""
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size,
        sampler=EpochSampler(len(dataset), batch_size, shuffle, seed,
                             drop_last),
        drop_last=drop_last, num_workers=num_workers,
        collate_fn=stack_collate, persistent_workers=num_workers > 0,
        multiprocessing_context="spawn" if num_workers else None)
