"""Host-side data loading: samples decode in a thread pool, a few batches
ahead of the consumer, and are collated to numpy (counterpart of
``sprc_tpu/data/loader.py``, for one host: no per-host shards).

- ``shuffle``: each epoch's order is ``np.random.RandomState(seed +
  epoch).permutation`` (call :meth:`DataLoader.set_epoch` like a
  ``DistributedSampler``), the JAX loader's order;
- ``drop_last``: no short last batch (static train shapes);
- a ``None`` sample (a dataset in ``skip_errors`` mode) is dropped with a
  warning and counted; a sample that raises raises from the iterator.
"""

from __future__ import annotations

import collections
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List

import numpy as np

log = logging.getLogger(__name__)


def default_collate(samples: List[dict]) -> dict:
    """Stack numpy/array leaves; keep strings/lists as lists."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Map-style loader: every sample is its own task in the pool, so a
    batch decodes ``num_workers`` ways at once. At most ``prefetch + 1``
    batches are in flight, so host memory stays bounded on a large gallery.
    ``dropped_total`` counts the ``None`` samples dropped over the loader's
    life."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, prefetch: int = 2, *,
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.dropped_total = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        """This epoch's sample order."""
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        idx, bs = self.indices(), self.batch_size
        dropped = 0

        def collate(futures) -> List[dict]:
            """One batch's samples, the ``None`` ones dropped and counted
            (here, in the consumer's thread); no batch where none is left."""
            nonlocal dropped
            samples = []
            for j, f in futures:
                s = f.result()
                if s is None:
                    log.warning("dropped unreadable sample %d", j)
                    dropped += 1
                    self.dropped_total += 1
                else:
                    samples.append(s)
            return [default_collate(samples)] if samples else []

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: collections.deque = collections.deque()
            try:
                for i in range(len(self)):
                    pending.append([(int(j), pool.submit(self.dataset.__getitem__, int(j)))
                                    for j in idx[i * bs: (i + 1) * bs]])
                    if len(pending) > self.prefetch:
                        yield from collate(pending.popleft())
                while pending:
                    yield from collate(pending.popleft())
            finally:
                for futures in pending:
                    for _, f in futures:
                        f.cancel()
                if dropped:
                    log.warning("epoch %d: dropped %d/%d unreadable samples (total this "
                                "loader: %d)", self.epoch, dropped, len(idx), self.dropped_total)
