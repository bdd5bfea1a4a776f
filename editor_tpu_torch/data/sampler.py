"""Identity-balanced P x K batch sampling: the port's copy of
``editor_tpu/data/sampler.py`` (reference: data/datasets/sampler.py
RandomIdentitySampler, sampler_ddp.py).

A deterministic host-side index generator seeded by (seed, epoch): numpy's
``RandomState((seed * 1_000_003 + epoch) % 2**31)``, the JAX package's
formula, so both packages draw the same index arrays. ``host_shard`` slices
each global batch into contiguous per-host blocks (sampler_ddp.py:159-168).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


def _epoch_rng(seed: int, epoch: int) -> np.random.RandomState:
    return np.random.RandomState((seed * 1_000_003 + epoch) % (2**31))


def _host_shard(full: np.ndarray, batch_size: int, host_id: int,
                num_hosts: int) -> np.ndarray:
    """Host ``host_id``'s contiguous block of each global batch of ``full``."""
    per_host = batch_size // num_hosts
    out = [full[b * batch_size + host_id * per_host:b * batch_size + (host_id + 1) * per_host]
           for b in range(len(full) // batch_size)]
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

    def host_shard(self, epoch: int, host_id: int, num_hosts: int) -> np.ndarray:
        return _host_shard(self.epoch_indices(epoch), self.batch_size, host_id, num_hosts)


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

    def host_shard(self, epoch: int, host_id: int, num_hosts: int) -> np.ndarray:
        return _host_shard(self.epoch_indices(epoch), self.batch_size, host_id, num_hosts)
