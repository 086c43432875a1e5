"""Host-side data loading: samples decode in a thread pool, a few batches
ahead of the consumer, and are collated to numpy (counterpart of
``sprc_tpu/data/loader.py``).

- ``host_id`` / ``num_hosts``: the JAX loader's per-host shard
  (:func:`host_shard`, contiguous), then the epoch's permutation of it; no
  CLI sets them, in either package;
- ``shuffle``: each epoch's order is ``np.random.RandomState(seed +
  epoch).permutation`` (call :meth:`DataLoader.set_epoch` like a
  ``DistributedSampler``), the JAX loader's order;
- ``rank`` / ``world`` (``--mesh``): the same order cut into the global
  batches of ``batch_size`` one device would get, and each of those into
  ``world`` slices; this rank yields (and decodes) only its slice of
  ``batch_size / world`` rows. A ``batch_size`` the world does not divide
  is refused, and so (over two ranks or more) is a ``None`` sample;
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


def host_shard(n: int, host_id: int, num_hosts: int) -> range:
    """Contiguous per-host index shard."""
    per = (n + num_hosts - 1) // num_hosts
    return range(host_id * per, min(n, (host_id + 1) * per))


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
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1, rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"a batch of {batch_size} does not divide over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.host_id, self.num_hosts = host_id, num_hosts
        self.rank, self.world = rank, world
        self.dropped_total = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        """This epoch's sample order (of this host's shard)."""
        idx = np.asarray(host_shard(len(self.dataset), self.host_id, self.num_hosts))
        if self.shuffle:
            return idx[np.random.RandomState(self.seed + self.epoch).permutation(len(idx))]
        return idx

    def __len__(self) -> int:
        """Global batches an epoch."""
        n = len(host_shard(len(self.dataset), self.host_id, self.num_hosts))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _mine(self, batch: np.ndarray) -> np.ndarray:
        """This rank's contiguous slice of a global batch (a short last
        batch is cut as :func:`host_shard` cuts it)."""
        part = host_shard(len(batch), self.rank, self.world)
        return batch[part.start: part.stop]

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
                    if self.world > 1:  # the ranks' slices must stay equal for the gathers
                        raise RuntimeError(f"unreadable sample {j} on rank {self.rank} of "
                                           f"{self.world}: a rank cannot drop a sample")
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
                                    for j in self._mine(idx[i * bs: (i + 1) * bs])])
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
