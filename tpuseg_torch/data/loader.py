"""Background-prefetch batch loader (own copy of ``tpuseg/data/loader.py``).

A thread pool runs ``AlignCollate`` for the next batches while the card
runs the current step; a bounded window of futures keeps at most
``prefetch`` batches in flight.  The raw reads are the record file's mmap
slices (the JAX package's optional C++ gather is not ported).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from tpuseg_torch.data.dataset import AlignCollate


class PrefetchLoader:
    """Batches of an indexable dataset, built by background workers.

    Deterministic given (seed, epoch): the index order and each batch's
    augmentation generator derive from them, whatever the threads' timing,
    and are those of the JAX package's loader."""

    def __init__(self, dataset, collate: AlignCollate, batch_size: int,
                 shuffle: bool, seed: int, n_workers: int = 2,
                 prefetch: int = 2, drop_last: bool = False):
        self.dataset = dataset
        self.collate = collate
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.n_workers = max(1, n_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        if self.shuffle:
            rng.shuffle(order)
        starts = list(range(0, len(order), self.batch_size))
        if self.drop_last:
            starts = [s for s in starts if s + self.batch_size <= len(order)]

        def build(bi: int):
            idx = order[starts[bi]:starts[bi] + self.batch_size]
            brng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, int(bi)]))
            samples = [self.dataset[int(i)] for i in idx]
            return self.collate(samples, rng=brng).asdict()

        with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
            futures = {bi: pool.submit(build, bi)
                       for bi in range(min(self.prefetch, len(starts)))}
            for bi in range(len(starts)):
                batch = futures.pop(bi).result()
                nxt = bi + self.prefetch
                if nxt < len(starts):
                    futures[nxt] = pool.submit(build, nxt)
                yield batch
