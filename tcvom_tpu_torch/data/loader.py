"""Epoch order and batching of the training data (port of
tcvom_tpu/data/loader.py on ``torch.utils.data``).

:func:`epoch_indices` is the JAX package's deterministic per-epoch
shuffle, padded by wrapping to whole batches and sharded over the ranks
of a data-parallel run (DistributedSampler semantics, in blocks of the
per-rank batch). :class:`EpochSampler` yields the keys ``(epoch, idx)``,
and the datasets draw an item's randomness from ``(seed, epoch, idx)``
alone: an item is the same whichever process reads it, and a new epoch
reaches worker processes started in an earlier one (a ``set_epoch`` on
the main process's dataset would not).
"""
from __future__ import annotations

import numpy as np
import torch.utils.data


def epoch_indices(n: int, epoch: int, shuffle: bool, seed: int = 0,
                  drop_last: bool = True, block: int = 1,
                  num_shards: int = 1, shard: int = 0) -> np.ndarray:
    """Shard ``shard``'s sample order in ``epoch`` of ``num_shards``
    (tcvom_tpu/data/loader.py:18-52): a permutation from ``seed + epoch``
    (or 0..n-1), the same on every shard, wrapped up to whole chunks of
    ``num_shards * block`` when sharded or when ``drop_last``; each shard
    takes its run of ``block`` out of every chunk. With ``block`` the
    per-rank batch, the ranks' k-th batches, concatenated in rank order,
    are the k-th batch of one process at ``num_shards * block``, so
    per-sample randomness drawn for the global batch pairs with the same
    sample at any number of ranks."""
    idx = np.arange(n)
    if shuffle:
        idx = np.random.RandomState(seed + epoch).permutation(n)
    if num_shards > 1 or (drop_last and n % (num_shards * block)):
        chunk = num_shards * block
        total = ((n + chunk - 1) // chunk) * chunk
        reps = -(-(total - n) // max(n, 1)) + 1
        idx = np.tile(idx, reps)[:total]
        idx = idx.reshape(-1, num_shards, block)[:, shard].reshape(-1)
    return idx


def sweep_indices(n: int, block: int, num_shards: int = 1,
                  shard: int = 0) -> np.ndarray:
    """Shard ``shard``'s samples of an evaluation sweep over 0..n-1 in
    batches of ``block``: the one-process sweep's batches dealt round
    robin (batch k to shard k % num_shards), nothing wrapped, so that
    every sample is read once and each batch holds the samples of the
    one-process batch it is."""
    idx = np.arange(n)
    return np.concatenate(
        [idx[i:i + block] for i in range(shard * block, n,
                                          num_shards * block)] or
        [idx[:0]])


class EpochSampler(torch.utils.data.Sampler):
    """The keys ``(epoch, idx)`` of the epoch set by :meth:`set_epoch`, in
    :func:`epoch_indices`' order for batches of ``batch_size`` on
    ``shard`` of ``num_shards`` (with ``drop_last``; without it, the
    unwrapped :func:`sweep_indices` of an evaluation)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, num_shards: int = 1,
                 shard: int = 0):
        self.n, self.batch_size, self.shuffle = n, batch_size, shuffle
        self.seed, self.drop_last = seed, drop_last
        self.num_shards, self.shard = num_shards, shard
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        if not self.drop_last and self.num_shards > 1:
            if self.shuffle:
                raise ValueError("a sharded sweep without drop_last is in "
                                 "order")
            return sweep_indices(self.n, self.batch_size, self.num_shards,
                                 self.shard)
        return epoch_indices(self.n, self.epoch, self.shuffle, self.seed,
                             drop_last=self.drop_last, block=self.batch_size,
                             num_shards=self.num_shards, shard=self.shard)

    def __iter__(self):
        return iter([(self.epoch, int(i)) for i in self._indices()])

    def __len__(self) -> int:
        return len(self._indices())


def stack_collate(items: list[dict]) -> dict:
    """Stack each key's numpy arrays along a new batch axis."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def make_loader(dataset, batch_size: int, num_workers: int = 0,
                shuffle: bool = False, seed: int = 0,
                drop_last: bool = False, num_shards: int = 1,
                shard: int = 0) -> torch.utils.data.DataLoader:
    """Batches of numpy arrays in :class:`EpochSampler`'s order, the JAX
    package's ``DataLoader``: by default in order with a short last batch
    (the evaluation sweeps'), or shuffled and wrapped to whole batches
    (``shuffle=True, drop_last=True``, the trainer's); rank ``shard`` of
    ``num_shards`` reads its own batches of ``batch_size``. ``set_epoch``
    is the sampler's: ``loader.sampler.set_epoch``. Worker processes are
    spawned, not forked (the caller has CUDA's threads and the intra-op
    pool), and kept across epochs; each imports torch and this package
    before its first item."""
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size,
        sampler=EpochSampler(len(dataset), batch_size, shuffle, seed,
                             drop_last, num_shards, shard),
        drop_last=drop_last, num_workers=num_workers,
        collate_fn=stack_collate, persistent_workers=num_workers > 0,
        multiprocessing_context="spawn" if num_workers else None)
