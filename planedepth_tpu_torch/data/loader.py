"""Deterministic batch loader with background prefetch, for one process
(``planedepth_tpu/data/loader.py`` at one host, which the tests hold it to).

Replaces the reference's DataLoader + rmnone_collate stack
(trainer.py:136-150, utils.py:141-194):

  * ``EpochSampler`` — a per-epoch permutation from (seed, epoch), cut or
    padded to whole batches, as a pure function of the epoch;
  * ``BatchLoader`` — a thread pool decodes/augments samples and a
    double-buffered prefetcher overlaps host work with device steps;
  * samples that fail to load (the reference's ``rmnone_collate`` None-drop
    for missing colmap poses) are resampled deterministically from the same
    epoch permutation instead of shrinking the batch, so every step sees
    the same batch shape.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

PREFETCH = 2          # batches made ahead of the step


class EpochSampler:
    """Deterministic per-epoch permutation, in batches."""

    def __init__(
        self,
        num_samples: int,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 1,
        drop_last: bool = True,
    ):
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """The epoch's sample order."""
        if self.shuffle:
            rng = np.random.default_rng([self.seed, epoch])
            order = rng.permutation(self.num_samples)
        else:
            order = np.arange(self.num_samples)
        if self.drop_last:
            usable = (len(order) // self.batch_size) * self.batch_size
            order = order[:usable]
        else:
            pad = (-len(order)) % self.batch_size
            if pad:
                # cyclic repeat: order[:pad] is too short when the split
                # is smaller than one batch (tiny val splits)
                order = np.concatenate([order, np.resize(order, pad)])
        return order

    def batches(self, epoch: int) -> np.ndarray:
        """(steps, batch_size) index matrix."""
        return self.epoch_indices(epoch).reshape(-1, self.batch_size)

    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into a batch dict (keys intersected —
    e.g. samples missing velodyne depth drop the depth keys batch-wide,
    mirroring the reference's behavior of only collating common keys)."""
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    return {k: np.stack([s[k] for s in samples]) for k in sorted(keys)}


class BatchLoader:
    """Iterates deterministic batches with background prefetch."""

    def __init__(self, dataset, sampler: EpochSampler, num_workers: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.num_workers = max(1, num_workers)

    def _load_one(self, idx: int, epoch: int) -> Optional[Dict]:
        try:
            return self.dataset.getitem(int(idx), epoch=epoch)
        except Exception:
            return None

    def _make_batch(self, indices: np.ndarray, epoch: int, fallback: np.ndarray,
                    executor: ThreadPoolExecutor) -> Dict[str, np.ndarray]:
        # decode/augment the batch in parallel (the reference uses 12 worker
        # PROCESSES, options.py:217-220; PIL decode and np IO release the
        # GIL so threads suffice here and keep arrays zero-copy)
        samples: List[Optional[Dict]] = list(
            executor.map(lambda i: self._load_one(i, epoch), indices))
        # deterministic resample of failures, in batch-position order, from
        # the epoch permutation (replaces the reference's rmnone_collate
        # None-drop — every step keeps the batch shape)
        fb = iter(fallback)
        out: List[Dict] = []
        for s in samples:
            while s is None:
                try:
                    s = self._load_one(next(fb), epoch)
                except StopIteration:
                    raise RuntimeError("all fallback samples failed to load")
            out.append(s)
        return collate(out)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        batches = self.sampler.batches(epoch)
        fallback = self.sampler.epoch_indices(epoch)
        pool = ThreadPoolExecutor(self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        failure: List[BaseException] = []

        def producer():
            try:
                for step_idx in batches:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(step_idx, epoch, fallback, pool))
            except BaseException as e:   # propagate to the consumer —
                failure.append(e)        # a swallowed loader failure
            finally:                     # would silently truncate the
                q.put(None)              # epoch (and the LR schedule)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    if failure:
                        raise RuntimeError("BatchLoader producer failed") from failure[0]
                    break
                yield b
        finally:
            stop.set()
            pool.shutdown(wait=False)
