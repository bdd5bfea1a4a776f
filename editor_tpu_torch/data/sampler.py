"""Identity-balanced P x K batch sampling: the port's copy of
``editor_tpu/data/sampler.py`` (reference: data/datasets/sampler.py
RandomIdentitySampler, sampler_ddp.py).

A deterministic host-side index generator seeded by (seed, epoch): numpy's
``RandomState((seed * 1_000_003 + epoch) % 2**31)``, the JAX package's
formula, so both packages draw the same index arrays. ``host_shard`` slices
each global batch into contiguous per-host blocks (sampler_ddp.py:159-168),
one in each microbatch under gradient accumulation. Beside them, off the
main path as in JAX: ``CyclingIterator`` and the cross-modal
``IdentitySampler``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


def _epoch_rng(seed: int, epoch: int) -> np.random.RandomState:
    return np.random.RandomState((seed * 1_000_003 + epoch) % (2**31))


def host_rows(batch_size: int, host_id: int, num_hosts: int,
              grad_accum: int = 1) -> np.ndarray:
    """The rows of a global batch that host ``host_id`` of ``num_hosts``
    holds: its contiguous block of each of the ``grad_accum`` microbatches
    (of the whole batch when 1), so that its local microbatch i is its part
    of global microbatch i."""
    if batch_size % (num_hosts * grad_accum):
        raise ValueError(f"batch of {batch_size} rows does not split over {num_hosts} "
                         f"hosts x {grad_accum} microbatches")
    mb, per = batch_size // grad_accum, batch_size // (grad_accum * num_hosts)
    return np.concatenate([np.arange(i * mb + host_id * per, i * mb + (host_id + 1) * per)
                           for i in range(grad_accum)])


def _host_shard(full: np.ndarray, batch_size: int, host_id: int, num_hosts: int,
                grad_accum: int = 1) -> np.ndarray:
    """Host ``host_id``'s rows (:func:`host_rows`) of each global batch of ``full``."""
    rows = host_rows(batch_size, host_id, num_hosts, grad_accum)
    out = [full[b * batch_size + rows] for b in range(len(full) // batch_size)]
    return np.concatenate(out) if out else np.empty((0,), dtype=np.int64)


class PKSampler:
    """Yields epochs of indices grouped as P ids x K instances per batch."""

    def __init__(self, items: Sequence, batch_size: int, num_instances: int,
                 seed: int = 0):
        if batch_size % num_instances != 0:
            raise ValueError("batch_size must be divisible by num_instances")
        self.batch_size = batch_size
        self.num_instances = num_instances
        self.num_pids_per_batch = batch_size // num_instances
        self.seed = seed
        self.index_by_pid: Dict[int, List[int]] = defaultdict(list)
        for idx, item in enumerate(items):
            self.index_by_pid[item[1]].append(idx)
        self.pids = sorted(self.index_by_pid)
        # epoch length estimate (reference: sampler.py:28-35)
        self.length = 0
        for pid in self.pids:
            num = max(len(self.index_by_pid[pid]), num_instances)
            self.length += num - num % num_instances

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """Full-epoch index array, length a multiple of batch_size: per-pid
        shuffled chunks of K, then batches of P random available pids
        (reference sampler.py:37-62)."""
        rng = _epoch_rng(self.seed, epoch)
        chunks: Dict[int, List[np.ndarray]] = {}
        for pid in self.pids:
            idxs = np.asarray(self.index_by_pid[pid])
            if len(idxs) < self.num_instances:
                idxs = rng.choice(idxs, size=self.num_instances, replace=True)
            rng.shuffle(idxs)
            n_full = len(idxs) // self.num_instances
            chunks[pid] = [idxs[i * self.num_instances:(i + 1) * self.num_instances]
                           for i in range(n_full)]
        avail = [pid for pid in self.pids if chunks[pid]]
        out: List[np.ndarray] = []
        while len(avail) >= self.num_pids_per_batch:
            sel = rng.choice(len(avail), self.num_pids_per_batch, replace=False)
            for pid in [avail[i] for i in sel]:
                out.append(chunks[pid].pop(0))
                if not chunks[pid]:
                    avail.remove(pid)
        if not out:
            return np.empty((0,), dtype=np.int64)
        return np.concatenate(out).astype(np.int64)

    def host_shard(self, epoch: int, host_id: int, num_hosts: int,
                   grad_accum: int = 1) -> np.ndarray:
        return _host_shard(self.epoch_indices(epoch), self.batch_size, host_id, num_hosts,
                           grad_accum)


class SoftmaxSampler:
    """Plain shuffled sampling for SAMPLER='softmax' mode."""

    def __init__(self, num_items: int, batch_size: int, seed: int = 0):
        self.num_items = num_items
        self.batch_size = batch_size
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = _epoch_rng(self.seed, epoch).permutation(self.num_items)
        n = (len(idx) // self.batch_size) * self.batch_size
        return idx[:n].astype(np.int64)

    def host_shard(self, epoch: int, host_id: int, num_hosts: int,
                   grad_accum: int = 1) -> np.ndarray:
        return _host_shard(self.epoch_indices(epoch), self.batch_size, host_id, num_hosts,
                           grad_accum)


class CyclingIterator:
    """Cycle a per-epoch iterator ``n`` times (reference
    elastic/utils/data/cycling_iterator.py): ``generator_fn(epoch)`` builds
    the epoch's iterator, so an elastic training loop consumes one
    continuous stream across epochs."""

    def __init__(self, n: int, generator_fn, start_epoch: int = 0):
        self._n = n
        self._epoch = start_epoch
        self._generator_fn = generator_fn
        self._iter = generator_fn(self._epoch)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                return next(self._iter)
            except StopIteration:
                if self._epoch >= self._n - 1:
                    raise
                self._epoch += 1
                self._iter = self._generator_fn(self._epoch)


class IdentitySampler:
    """Cross-modal identity sampler (reference data/datasets/sampler.py,
    unused on the reference's main path): per batch, ``batch_size``
    identities without replacement and ``num_pos`` samples of each from
    each modality's index lists, drawn from numpy's ``RandomState(seed)`` in
    the JAX package's order (the same indices)."""

    def __init__(self, color_labels, thermal_labels, color_pos, thermal_pos,
                 num_pos: int, batch_size: int, seed: int = 0):
        rng = np.random.RandomState(seed)
        uni = np.unique(color_labels)
        N = max(len(color_labels), len(thermal_labels))
        idx1, idx2 = [], []
        for _ in range(N // (batch_size * num_pos) + 1):
            batch_ids = rng.choice(uni, batch_size, replace=False)
            for pid in batch_ids:
                idx1.append(rng.choice(color_pos[pid], num_pos))
                idx2.append(rng.choice(thermal_pos[pid], num_pos))
        self.index1 = np.concatenate(idx1)
        self.index2 = np.concatenate(idx2)
        self.N = N

    def __iter__(self):
        return iter(np.arange(len(self.index1)))

    def __len__(self):
        return self.N
