"""Deterministic host-sharded batch loader with background prefetch
(``planedepth_tpu/data/loader.py``, which the tests hold it to).

Replaces the reference's DataLoader + DistributedSampler + rmnone_collate stack
(trainer.py:136-150, utils.py:141-194):

  * ``EpochSampler`` — the DistributedSampler semantics (a per-epoch
    permutation from (seed, epoch), cut or padded to a multiple of
    num_hosts x batch, sliced per host) as a pure function of the epoch;
  * ``BatchLoader`` — a thread pool decodes/augments samples and a
    double-buffered prefetcher overlaps host work with device steps;
  * samples of a training set that fail to load (the reference's
    ``rmnone_collate`` None-drop for missing colmap poses) are resampled
    deterministically from the same epoch permutation instead of shrinking
    the batch, so every step sees the same batch shape.  An evaluation set
    (``dataset.is_train`` False) raises the failure instead: another frame
    in its place would be scored against the missing frame's ground truth.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence

import numpy as np

PREFETCH = 2          # batches made ahead of the step


class EpochSampler:
    """Deterministic per-epoch permutation, sharded across hosts (the JAX
    sampler, bit for bit): the global order is padded or cut to whole
    chunks of ``num_hosts * batch_size``, and host ``host_id`` takes its
    ``batch_size`` columns of each chunk."""

    def __init__(
        self,
        num_samples: int,
        batch_size: int,
        num_hosts: int = 1,
        host_id: int = 0,
        shuffle: bool = True,
        seed: int = 1,
        drop_last: bool = True,
    ):
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """Global sample order for an epoch (same on every host)."""
        if self.shuffle:
            rng = np.random.default_rng([self.seed, epoch])
            order = rng.permutation(self.num_samples)
        else:
            order = np.arange(self.num_samples)
        chunk = self.batch_size * self.num_hosts
        if self.drop_last:
            usable = (len(order) // chunk) * chunk
            order = order[:usable]
        else:
            pad = (-len(order)) % chunk
            if pad:
                # cyclic repeat: order[:pad] is too short when the split
                # is smaller than one global chunk (tiny val splits)
                order = np.concatenate([order, np.resize(order, pad)])
        return order

    def host_batches(self, epoch: int) -> np.ndarray:
        """(steps, batch_size) index matrix for this host."""
        order = self.epoch_indices(epoch)
        order = order.reshape(-1, self.num_hosts, self.batch_size)
        return order[:, self.host_id, :]

    def steps_per_epoch(self) -> int:
        chunk = self.batch_size * self.num_hosts
        if self.drop_last:
            return self.num_samples // chunk
        return -(-self.num_samples // chunk)


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
        # datasets without the attribute resample, as the JAX loader does
        self.resample = getattr(dataset, "is_train", True)

    def _load_one(self, idx: int, epoch: int):
        """The sample, or what stands for its failure where failures are
        resampled: None (the dataset dropped it) or the exception raised."""
        try:
            sample = self.dataset.getitem(int(idx), epoch=epoch)
        except Exception as e:
            if not self.resample:
                raise
            return e
        if sample is None and not self.resample:
            raise RuntimeError(f"sample {int(idx)} of an evaluation set has no data")
        return sample

    def _make_batch(self, indices: np.ndarray, epoch: int, fallback: np.ndarray,
                    executor: ThreadPoolExecutor) -> Dict[str, np.ndarray]:
        # decode/augment the batch in parallel (the reference uses 12 worker
        # PROCESSES, options.py:217-220; PIL decode and np IO release the
        # GIL so threads suffice here and keep arrays zero-copy)
        samples = list(executor.map(lambda i: self._load_one(i, epoch), indices))
        # deterministic resample of failures, in batch-position order, from
        # the epoch permutation (replaces the reference's rmnone_collate
        # None-drop — every step keeps the batch shape)
        fb = iter(fallback)
        out: List[Dict] = []
        for s in samples:
            while s is None or isinstance(s, Exception):
                idx = next(fb, None)
                if idx is None:
                    raise RuntimeError(f"all fallback samples failed to load; the last: "
                                       f"{s!r}") from (s if isinstance(s, Exception) else None)
                s = self._load_one(idx, epoch)
            out.append(s)
        return collate(out)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        batches = self.sampler.host_batches(epoch)
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
                        raise RuntimeError(
                            f"BatchLoader producer failed: {failure[0]}") from failure[0]
                    break
                yield b
        finally:
            stop.set()
            pool.shutdown(wait=False)
